#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Builds the three CUDA kernels from ``src/repro_torch/csrc/`` (one nvcc per
source, all at once) and runs, each phase failing loudly:

  0. the card: nvidia-smi's name and power limit, TF32 off for the plain
     versions (the plain depth-wise version goes through cuDNN);
  1. every kernel against its plain PyTorch version at every instruction
     shape of both programs, m_active 1 and 2, the compiled batch and a
     ragged batch of 3, plus the matmul with group_size 675 (not a multiple
     of 8); tolerance rtol 1e-5, atol 1e-4 (the reference's).  A second tile
     plan of each kernel (``ALT_PLAN``, which no pick may equal) must agree
     bit for bit (torch.equal);
  2. CNN-A (48²x3, 43 classes, M=2) at batch 64 through compile -> execute
     under m_active None, 1 and a per-layer schedule, against
     execute_reference; 2 conv + 3 matmul launches per call;
  3. MobileNetV1 (width 1.0, 224²x3, 1000 classes, M=2) at batch 16, the
     same checks; 14 conv + 13 dwconv + 1 matmul launches per call.  Neither
     network's execute may pick a tile plan;
  4. timings: per kernel and instruction shape, the kernel, its plain
     version and one PyTorch library call for the same core function
     (timed here only, never called by the port), each from CUDA events
     around a CUDA graph of repeated calls; per-forward time of each network.
     ``ms`` is the kernel's wrapper alone, the same work as the library
     call; ``instr_ms`` the whole instruction (a linear one adds its bias
     and ReLU as two more launches);
  5. torch.profiler over three warm execute calls of each network: device
     time by kernel name (top 10) and the device's idle share over the
     window; the chrome traces go to ``chiprun_out/trace_<net>.json``;
  6. serve: MobileNetV1-224 compiled at batch 16 with its golden record
     (3 rungs, self-tested), saved and loaded back onto the card through a
     checksummed checkpoint (``torch.equal``, verified, self-tested), served
     by ``CNNService`` (48 images at rung 0 and 16 at the lowest rung, each
     ``torch.equal`` to ``deploy.execute`` on the padded batch), one
     injected error and one injected NaN retried and reconciled with the
     injector's ledger, an in-memory bit flip caught by the watchdog and
     hot-reloaded, a flipped bit on disk quarantined by
     ``load_latest_good``; then the median ``step()`` over 10 warm batches
     on the host clock, split by CUDA events into assembly + H2D copy,
     ``execute``, and screen + D2H copy.  Its own launches are counted and
     every kernel must run; checkpoints go to ``chiprun_out/serve_ckpt/``.

Weights are random, drawn from a seeded generator.  The logits of phases 2
and 3 are compared with rtol 1e-4 and atol 1e-4·max|logit| (a relative
floor: the reference's random MobileNet init shrinks activations to ~1e-13
by the head, and 28 layers of fp32 sums run in another order on each side).

Prints a ``{"kernels": [...]}`` JSON line (``launches`` counts phases 2
and 3, ``serve_launches`` phase 6), nvidia-smi's line, and last
``{"ok": true, "device": {...}}``; per-instruction numbers go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
without a card or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch import deploy
    from repro_torch.core import binarize as bz
    from repro_torch.core.binconv import pad_nhwc
    from repro_torch.core.binlinear import QuantConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.binary_conv import unpack_taps
    from repro_torch.kernels.binary_dwconv import unpack_dw_taps
    from repro_torch.models import cnn
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.serve_cnn import CNNService, default_ladder
    from repro_torch.testing.faults import FaultInjector, FaultPlan, inject_faults
except ImportError as e:
    raise SystemExit(f"chip_smoke: FAILED: the port is not importable from "
                     f"{ROOT / 'src'}: {e}") from e

FP32_FLOPS = 67e12         # H100 SXM fp32 (non-tensor) peak, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 bandwidth, NVIDIA data sheet
RTOL, ATOL = 1e-5, 1e-4
TPU_KERNELS = {  # name -> (CUDA source, TPU kernel it replaces)
    "binary_conv": ("src/repro_torch/csrc/binary_conv.cu",
                    "src/repro/kernels/binary_conv.py:416"),
    "binary_dwconv": ("src/repro_torch/csrc/binary_dwconv.cu",
                      "src/repro/kernels/binary_dwconv.py:168"),
    "binary_matmul": ("src/repro_torch/csrc/binary_matmul.cu",
                      "src/repro/kernels/binary_matmul.py:92"),
}
KERNEL_OF = {"conv": "binary_conv", "dwconv": "binary_dwconv", "linear": "binary_matmul"}
ALT_PLAN = {"conv": (64, 32), "dwconv": (2, 256), "linear": (2, 64)}
EXPECTED_LAUNCHES = {
    "cnn_a": {"binary_conv": 2, "binary_dwconv": 0, "binary_matmul": 3},
    "mobilenet": {"binary_conv": 14, "binary_dwconv": 13, "binary_matmul": 1},
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def single(instr, plan, batch: int):
    """A one-instruction program over the instruction's post-pre input."""
    one = dataclasses.replace(instr, pre="none", plan=deploy.TilePlan(*plan))
    return deploy.BinArrayProgram((one,), instr.name,
                                  (batch,) + tuple(instr.stats.in_shape[1:]))


def layer_input(instr, batch: int, gen: torch.Generator, dev) -> torch.Tensor:
    return torch.randn((batch,) + tuple(instr.stats.in_shape[1:]), generator=gen).to(dev)


def check_kernels(programs: dict, gen: torch.Generator, dev) -> dict:
    """Phase 1: each kernel against its plain version at every instruction
    shape; returns the largest |kernel - plain| per kernel."""
    max_err = {k: 0.0 for k in TPU_KERNELS}

    def compare(where, instr, batch, m, alt_plan):
        x = layer_input(instr, batch, gen, dev)
        got = deploy.execute(single(instr, instr.plan, batch), x, m)
        want = deploy.execute_reference(single(instr, instr.plan, batch), x, m)
        err = float((got - want).abs().max())
        kern = KERNEL_OF[instr.kind]
        max_err[kern] = max(max_err[kern], err)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"{where} batch {batch} m {m}: kernel vs plain max |d| {err:.3g}")
        if alt_plan is not None:
            alt = deploy.execute(single(instr, alt_plan, batch), x, m)
            if not torch.equal(got, alt):
                fail(f"{where} batch {batch} m {m}: plans {tuple(instr.plan)} and "
                     f"{alt_plan} differ")

    checks = 0
    for arch, program in programs.items():
        for instr in program.instrs:
            if tuple(instr.plan) == ALT_PLAN[instr.kind]:
                fail(f"{arch}/{instr.name}: the picked plan is the second plan "
                     f"{ALT_PLAN[instr.kind]}, so the bit-identity check would not bite")
            for batch in (program.input_shape[0], 3):
                for m in (1, 2):
                    compare(f"{arch}/{instr.name}", instr, batch, m, ALT_PLAN[instr.kind])
                    checks += 1
    # the matmul with alpha groups of 675 rows (not a multiple of 8), fc1's shape
    fc1 = programs["cnn_a"].instrs[2]
    approx = bz.algorithm2(torch.randn(1350, 340, generator=gen).to(dev), 2, K_iters=8,
                           group_size=675)
    grouped = dataclasses.replace(
        fc1, B_packed=bz.pack_bits(bz.pad_rows_to_byte(approx.B)).contiguous(),
        alpha=approx.alpha.contiguous(), group_size=675)
    for batch in (fc1.stats.in_shape[0], 3):
        for m in (1, 2):
            compare("cnn_a/fc1 group 675", grouped, batch, m, ALT_PLAN["linear"])
            checks += 1
    torch.cuda.synchronize()
    print(f"phase 1: {checks} kernel-vs-plain checks passed (rtol {RTOL}, atol {ATOL}), "
          f"second plans bit-identical; max |d| {json.dumps(max_err)}")
    return max_err


def run_main_path(phase: int, arch: str, program, x: torch.Tensor) -> dict:
    """Phases 2 and 3: execute under three schedules against
    execute_reference; returns the launches counted over the three calls."""
    total = {k: 0 for k in TPU_KERNELS}
    classes = program.instrs[-1].stats.out_shape[1]
    for m_active in (None, 1, [1 + (i % 2) for i in range(len(program))]):
        ops.reset_launch_counts()
        picks = ops.plan_pick_count()
        got = deploy.execute(program, x, m_active)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if ops.plan_pick_count() != picks:
            fail(f"{arch}: execute made {ops.plan_pick_count() - picks} plan picks")
        if counts != EXPECTED_LAUNCHES[arch]:
            fail(f"{arch} m_active={m_active}: launches {counts} != "
                 f"{EXPECTED_LAUNCHES[arch]}")
        for k, v in counts.items():
            total[k] += v
        want = deploy.execute_reference(program, x, m_active)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if tuple(got.shape) != (x.shape[0], classes):
            fail(f"{arch}: logits shape {tuple(got.shape)} != {(x.shape[0], classes)}")
        if not bool(torch.isfinite(got).all()) or scale == 0.0:
            fail(f"{arch}: logits not finite, or the reference's all zero")
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
            fail(f"{arch} m_active={m_active}: logits max |d| {err:.3g} "
                 f"(max |logit| {scale:.3g})")
        print(f"phase {phase}: {arch} m_active={m_active}: logits {tuple(got.shape)}, "
              f"max |logit| {scale:.4g}, max |d| vs plain {err:.3g}; launches {counts}; "
              f"no plan pick")
    return total


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around replays of a CUDA graph
    of ``reps`` calls (no host work inside the timed region)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def loop_ms(fn, reps: int = 10) -> float:
    """Time of one call issued from the host, host work included."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def library_call(instr, x: torch.Tensor):
    """One PyTorch call for the instruction's core function on the
    reconstructed weights (all levels): x @ W_hat, F.conv2d, or F.conv2d
    with groups=C; SAME padding is applied outside the call."""
    if instr.kind == "linear":
        B = bz.unpack_bits(instr.B_packed, instr.B_packed.shape[1] * 8)[:, :instr.K]
        W_hat = bz.reconstruct(bz.BinApprox(B, instr.alpha, instr.group_size))
        return lambda: x @ W_hat
    C = x.shape[-1]
    padding = instr.padding if instr.kind == "conv" else "SAME"
    xp = pad_nhwc(x, instr.kh, instr.kw, instr.stride, padding).permute(0, 3, 1, 2)
    if instr.kind == "conv":
        W_hat = bz.reconstruct(bz.BinApprox(unpack_taps(instr.B_tap_packed, C),
                                            instr.alpha, instr.group_size))
        w = W_hat.reshape(instr.kh, instr.kw, C, -1).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(xp, w, stride=instr.stride)
    W_hat = torch.einsum("mtc,mc->tc", unpack_dw_taps(instr.B_tap_packed, C).float(),
                         instr.alpha)
    w = W_hat.reshape(instr.kh, instr.kw, C).permute(2, 0, 1).unsqueeze(1).contiguous()
    return lambda: F.conv2d(xp, w, stride=instr.stride, groups=C)


def work(instr, batch: int) -> tuple[int, int]:
    """(bytes, flops) the instruction's function must move and do at all
    levels: each input read once (x, packed weights, alpha, bias), the
    output written once; 2 flops per fp-equivalent MAC."""
    weights = instr.B_packed if instr.kind == "linear" else instr.B_tap_packed
    x_numel = batch * math.prod(instr.stats.in_shape[1:])
    out_numel = batch * math.prod(instr.stats.out_shape[1:])
    nbytes = (4 * x_numel + weights.numel() + 4 * instr.alpha.numel()
              + 4 * instr.bias.numel() + 4 * out_numel)
    return nbytes, 2 * instr.stats.macs * batch


def time_kernels(programs: dict, gen: torch.Generator, dev) -> tuple[list, dict]:
    """Phase 4 per instruction: kernel, plain version, library call, bound."""
    rows = []
    totals = {k: {"ms": 0.0, "instr_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bytes": 0, "flops": 0} for k in TPU_KERNELS}
    for arch, program in programs.items():
        batch = program.input_shape[0]
        for instr in program.instrs:
            kern = KERNEL_OF[instr.kind]
            x = layer_input(instr, batch, gen, dev)
            prog1 = single(instr, instr.plan, batch)
            instr_ms = graph_ms(lambda: deploy.execute(prog1, x))
            # a linear instruction adds its bias and ReLU outside the kernel:
            # time the kernel alone, the same work as x @ W_hat
            ms = graph_ms(lambda: ops.binary_matmul(
                x, instr.B_packed, instr.alpha, K=instr.K, group_size=instr.group_size,
                plan=instr.plan)) if instr.kind == "linear" else instr_ms
            plain_ms = graph_ms(lambda: deploy.execute_reference(prog1, x), reps=5)
            lib_ms = graph_ms(library_call(instr, x))
            nbytes, flops = work(instr, batch)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            rows.append({"net": arch, "layer": instr.name, "kernel": kern,
                         "in_shape": [batch] + list(instr.stats.in_shape[1:]),
                         "plan": list(instr.plan), "ms": ms, "instr_ms": instr_ms,
                         "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": bound, "bytes": nbytes,
                         "flops": flops})
            for key, val in (("ms", ms), ("instr_ms", instr_ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bytes", nbytes), ("flops", flops)):
                totals[kern][key] += val
            print(f"  {arch} {instr.name} {kern} in {rows[-1]['in_shape']} plan "
                  f"{tuple(instr.plan)}: kernel {ms:.5f} ms, instruction {instr_ms:.5f} ms, "
                  f"plain {plain_ms:.5f} ms, "
                  f"library {lib_ms:.5f} ms, bound {bound:.5f} ms")
    return rows, totals


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_split(events: list) -> dict:
    """Device time by kernel name and the device's idle share, from the
    ``traceEvents`` of a chrome trace.  The window runs from the first span
    (host or device) to the end of the last device span; busy time is the
    union of the device spans."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if not device:
        fail("the profiler recorded no device time")
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    busy, reach = 0.0, -math.inf
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                              for e in device):
        if stop > reach:
            busy += stop - max(start, reach)
            reach = stop
    window = reach - min(float(e["ts"]) for e in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_us": window, "busy_us": busy, "idle_share": 1.0 - busy / window,
            "device_us_by_name": dict(top)}


def profile_forward(arch: str, program, x: torch.Tensor, out_dir: Path,
                    calls: int = 3) -> dict:
    """Phase 5: torch.profiler over ``calls`` warm execute calls, after one
    traced warm-up call that is dropped (the tracer's first launch pays for
    its buffers); writes the chrome trace to ``out_dir`` and prints the ten
    kernels with the most device time and the device's idle share over the
    window."""
    from torch.profiler import ProfilerActivity, profile, schedule
    path = out_dir / f"trace_{arch}.json"
    deploy.execute(program, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(1 + calls):
            deploy.execute(program, x)
            torch.cuda.synchronize()
            prof.step()
    split = device_split(json.loads(path.read_text())["traceEvents"])
    print(f"phase 5: {arch} profiler over {calls} execute calls: window "
          f"{split['window_us'] / 1e3:.4f} ms, device busy {split['busy_us'] / 1e3:.4f} ms, "
          f"idle share {split['idle_share']:.4f}; trace {path.relative_to(ROOT)}")
    for name, us in list(split["device_us_by_name"].items())[:10]:
        print(f"  {us / calls / 1e3:.5f} ms per call  {name[:110]}")
    return split

SERVE_BATCH = 16


def serve_phase(params: dict, quant, gen: torch.Generator, dev, out_dir: Path) -> dict:
    """Phase 6: the serving path of MobileNetV1-224 at batch 16 on the card.
    Every piece of the path runs inside ``counted`` (launch counts set to 0
    just before it and added up just after); the reference ``execute``
    calls that check its answers run outside it."""
    launches = {k: 0 for k in TPU_KERNELS}

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in ops.launch_counts().items():
            launches[k] += v
        return out

    def check_served(svc, done, n, rung):
        if len(done) != n or any(r.status != "done" for r in done):
            fail(f"serve: {[r.status for r in done]} (want {n} done), {svc.stats}")
        want = deploy.execute(svc.program, svc.last_batch, svc.last_schedule).cpu()
        for r in done:
            if r.rung != rung or r.m_schedule != svc.last_schedule \
                    or not torch.equal(r.logits, want[r.batch_index]):
                fail(f"serve: request {r.id} at rung {r.rung} is not torch.equal to "
                     f"execute on the padded batch at {svc.last_schedule}")

    def images(n):
        return [torch.randn(224, 224, 3, generator=gen).numpy() for _ in range(n)]

    shape = (SERVE_BATCH, 224, 224, 3)
    t0 = time.time()
    program = counted(lambda: deploy.compile(params, "mobilenet", quant, shape,
                                             device=dev, golden=True))
    compile_s = time.time() - t0
    rungs = program.golden.schedules()
    if len(rungs) != 3 or program.golden.device != dev.type:
        fail(f"serve: golden record {len(rungs)} rungs on {program.golden.device!r}, "
             f"want 3 on {dev.type!r}")
    t0 = time.perf_counter()
    again = counted(lambda: deploy.compute_golden(program))
    golden_s = time.perf_counter() - t0
    if again != program.golden:
        fail("serve: a second compute_golden gave other digests on the card")
    t0 = time.perf_counter()
    if counted(lambda: deploy.self_test(program)) != 3:
        fail("serve: self_test did not check 3 rungs")
    selftest_ms = (time.perf_counter() - t0) * 1e3
    print(f"phase 6: golden rungs {[list(r) for r in rungs]} (front half = first "
          f"{len(program) // 2} instructions); compile with golden {compile_s:.2f} s, "
          f"compute_golden {golden_s * 1e3:.1f} ms, self_test of 3 rungs "
          f"{selftest_ms:.1f} ms; digests {[d for _, d in program.golden.digests]}")

    ckpt_dir = out_dir / "serve_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir))
    deploy.save_program(mgr, 1, program)
    like = deploy.abstract_program("mobilenet", quant, shape, device=dev)
    loaded = counted(lambda: deploy.load_program(mgr, 1, like, verify=True))
    if loaded.device != program.device or loaded.golden != program.golden:
        fail(f"serve: loaded program on {loaded.device}, golden "
             f"{'equal' if loaded.golden == program.golden else 'differs'}")
    for a, b in zip(program.instrs, loaded.instrs):
        for f in a.TREE_FIELDS:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                fail(f"serve: {a.name}.{f} differs after the checkpoint round trip")
    counted(lambda: deploy.self_test(loaded))
    print(f"phase 6: checkpoint round trip onto {loaded.device}: "
          f"{sum(len(i.TREE_FIELDS) for i in loaded.instrs)} tensors torch.equal, "
          f"verified, golden re-attached, self_test passed")

    ladder = default_ladder(program)
    svc = CNNService(program, batch_size=SERVE_BATCH, max_queue=48, selftest_every=2,
                     checkpoint_manager=mgr, restore_like=like)
    if any(svc.submit(im).status != "queued" for im in images(48)):
        fail(f"serve: not all 48 images admitted: {svc.stats}")
    for _ in range(3):
        check_served(svc, counted(svc.step), SERVE_BATCH, 0)
    low = CNNService(program, batch_size=SERVE_BATCH, initial_rung=len(ladder) - 1)
    for im in images(16):
        low.submit(im)
    check_served(low, counted(low.step), SERVE_BATCH, len(ladder) - 1)
    if low.last_schedule != ladder[-1]:
        fail(f"serve: lowest rung served {low.last_schedule}, ladder ends {ladder[-1]}")
    print(f"phase 6: served 48 images at rung 0 and 16 at rung {len(ladder) - 1} "
          f"{list(ladder[-1])}, each torch.equal to execute; watchdog "
          f"{svc.stats['selftest_runs']} self-tests")

    faults = {}
    for kind, plan in (("error", FaultPlan(error_rate=1.0)), ("nan", FaultPlan(nan_rate=1.0))):
        with inject_faults(plan) as inj:
            def clear_on_sleep(dt, inj=inj):
                time.sleep(dt)
                inj.plan = FaultPlan()
            fsvc = CNNService(program, batch_size=SERVE_BATCH, backoff_s=0.001,
                              sleep=clear_on_sleep)
            for im in images(4):
                fsvc.submit(im)
            done = counted(fsvc.step)
        st = fsvc.stats
        check_served(fsvc, done, 4, 0)
        seen = st["exec_exceptions"] if kind == "error" else st["nonfinite_detected"]
        other = st["nonfinite_detected"] if kind == "error" else st["exec_exceptions"]
        if not (st["retries"] == 1 and seen == inj.counts[kind] == 1 and other == 0):
            fail(f"serve: injected {kind} not reconciled: stats {st}, injector {inj.counts}")
        faults[kind] = {"stats": st, "injected": inj.counts}
    print("phase 6: one injected error and one injected NaN each retried once and "
          "served clean; stats reconcile with the injector's counts")

    for im in images(16):
        svc.submit(im)
    check_served(svc, counted(svc.step), SERVE_BATCH, 0)
    clean = svc.program
    svc.program = FaultInjector(FaultPlan(seed=0)).flip_bit_in_program(svc.program)
    for im in images(16):
        svc.submit(im)
    done = counted(svc.step)
    st = svc.stats
    if st["selftest_failures"] != 1 or st["reloads"] != 1 or svc.last_reload_step != 1:
        fail(f"serve: in-memory bit flip not recovered: {st}")
    if svc.program.device != program.device:
        fail(f"serve: reloaded onto {svc.program.device}")
    check_served(svc, done, SERVE_BATCH, 0)
    want = deploy.execute(clean, svc.last_batch, svc.last_schedule).cpu()
    if not all(torch.equal(r.logits, want[r.batch_index]) for r in done):
        fail("serve: the batch after the hot reload differs from the clean program's")
    step_dir = deploy.save_program(mgr, 2, program)
    flipped = FaultInjector(FaultPlan(seed=0)).flip_bit_on_disk(step_dir)
    step, good = counted(lambda: deploy.load_latest_good(mgr, like))
    if step != 1 or [s for s, _ in mgr.quarantined] != [2] or good.device != program.device:
        fail(f"serve: load_latest_good returned step {step}, quarantined "
             f"{mgr.quarantined}")
    print(f"phase 6: in-memory bit flip caught by the watchdog and hot-reloaded from "
          f"step 1 (selftest_failures 1, reloads 1, next batch torch.equal to the clean "
          f"program's); disk flip in {flipped} of step 2 quarantined "
          f"({mgr.quarantine_dirs()}), load_latest_good returned step 1")

    timing = serve_timing(program, images)
    if any(v == 0 for v in launches.values()):
        fail(f"serve: a kernel of the path never launched in phase 6: {launches}")
    print(f"phase 6: launches {launches}")
    return {"rungs": [list(r) for r in rungs], "compile_s": compile_s,
            "compute_golden_ms": golden_s * 1e3, "self_test_3_rungs_ms": selftest_ms,
            "faults": faults, "recovery": svc.stats, "disk_flip_leaf": flipped,
            "timing": timing, "launches": launches}


def serve_timing(program, images, warm: int = 2, steps: int = 10) -> dict:
    """Median ``step()`` of a service at batch 16 on the host clock, and its
    split on the device timeline by CUDA events: before ``step`` -> before
    ``execute`` (assembly + H2D copy), -> after ``execute`` was issued and
    ran (execute), -> after ``step`` returned (screen, D2H copy and the
    service's bookkeeping)."""
    def timed(prog, x, m_active):
        ev["exec0"].record()
        y = deploy.execute(prog, x, m_active)
        ev["exec1"].record()
        return y

    svc = CNNService(program, batch_size=SERVE_BATCH, execute_fn=timed)
    rows = []
    for i in range(warm + steps):
        for im in images(SERVE_BATCH):
            svc.submit(im)
        ev = {k: torch.cuda.Event(enable_timing=True)
              for k in ("start", "exec0", "exec1", "end")}
        torch.cuda.synchronize()
        ev["start"].record()
        t0 = time.perf_counter()
        done = svc.step()
        t1 = time.perf_counter()
        ev["end"].record()
        ev["end"].synchronize()
        if len(done) != SERVE_BATCH or any(r.status != "done" for r in done):
            fail(f"serve timing: step {i} served {[r.status for r in done]}")
        if i >= warm:
            rows.append({"step_ms": (t1 - t0) * 1e3,
                         "assemble_h2d_ms": ev["start"].elapsed_time(ev["exec0"]),
                         "execute_ms": ev["exec0"].elapsed_time(ev["exec1"]),
                         "screen_d2h_ms": ev["exec1"].elapsed_time(ev["end"])})
    x = svc.last_batch
    alone = loop_ms(lambda: deploy.execute(program, x))
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    out = {**med, "images_per_s": SERVE_BATCH / med["step_ms"] * 1e3,
           "execute_alone_ms": alone, "steps": rows}
    print(f"phase 6: serve at batch {SERVE_BATCH} over {steps} warm steps: median step "
          f"{med['step_ms']:.4f} ms ({out['images_per_s']:.1f} images/s); split "
          f"assembly + H2D {med['assemble_h2d_ms']:.4f} ms, execute "
          f"{med['execute_ms']:.4f} ms, screen + D2H {med['screen_d2h_ms']:.4f} ms; "
          f"execute alone {alone:.4f} ms")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.time()
    _build.build_all()
    print(f"build: {len(_build.KERNELS)} kernels in {time.time() - t0:.1f} s")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    quant = QuantConfig(mode="binary", M=2)
    nets = {
        "cnn_a": (cnn.init_cnn_a(gen, device=dev), (64, 48, 48, 3)),
        "mobilenet": (cnn.init_mobilenet(gen, width_mult=1.0, n_classes=1000, device=dev),
                      (16, 224, 224, 3)),
    }
    programs = {}
    for arch, (params, shape) in nets.items():
        t0 = time.time()
        programs[arch] = deploy.compile(params, arch, quant, shape, device=dev,
                                        golden=False)
        torch.cuda.synchronize()
        print(f"compile {arch} {shape}: {len(programs[arch])} instructions, plans "
              f"{[tuple(i.plan) for i in programs[arch].instrs]}, {time.time() - t0:.1f} s")

    max_err = check_kernels(programs, gen, dev)

    inputs = {arch: torch.randn(p.input_shape, generator=gen).to(dev)
              for arch, p in programs.items()}
    launches = {k: 0 for k in TPU_KERNELS}
    for phase, arch in ((2, "cnn_a"), (3, "mobilenet")):
        for k, v in run_main_path(phase, arch, programs[arch], inputs[arch]).items():
            launches[k] += v

    rows, totals = time_kernels(programs, gen, dev)
    forward = {}
    for arch, program in programs.items():
        x = inputs[arch]
        forward[arch] = {"batch": program.input_shape[0],
                         "execute_ms": loop_ms(lambda: deploy.execute(program, x)),
                         "execute_reference_ms": loop_ms(
                             lambda: deploy.execute_reference(program, x), reps=3)}
        print(f"phase 4: {arch} forward at batch {program.input_shape[0]}: execute "
              f"{forward[arch]['execute_ms']:.4f} ms, execute_reference "
              f"{forward[arch]['execute_reference_ms']:.4f} ms (host work included)")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    profiles = {arch: profile_forward(arch, program, inputs[arch], out_dir)
                for arch, program in programs.items()}

    serve = serve_phase(nets["mobilenet"][0], quant, gen, dev, out_dir)

    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        tot = totals[name]
        t_bytes = tot["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = tot["flops"] / FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tot["library_ms"], "instr_ms": tot["instr_ms"],
            "serve_launches": serve["launches"][name]})
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": kind, "nvidia_smi": smi, "torch": torch.__version__,
         "kernels": kernels, "layers": rows, "forward": forward, "profiles": profiles,
         "serve": serve},
        indent=1))
    print("timings: ms, plain_ms, library_ms and bound_ms sum one forward of CNN-A "
          "(batch 64) and one of MobileNetV1-224 (batch 16); launches counts phases 2 "
          "and 3 (three calls of each network)")
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
