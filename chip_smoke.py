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
     every kernel must run; checkpoints go to ``chiprun_out/serve_ckpt/``;
  7. LM: gemma-2b at full width and depth (18 layers, d_model 2048, 8 heads
     x 256, MQA, d_ff 16384, vocab 256000, GeGLU, tied embeddings), fp32,
     M=2, its weights drawn on the card and binarized there layer by layer.
     The matmul kernel against its plain version at every LM linear shape
     (T = 1 and every row count the phase gives the kernel: the decode
     batch 8, each prefill bucket, 16 and 64; m_active 1 and 2; the second
     plan bit-identical); ``Server(max_batch=8, max_len=256)`` serving 8 requests
     (prompts of 5-60 tokens, 16 new tokens, m_active None / 1 / a per-layer
     schedule) with 18 x 7 matmul launches per decode group step, a mixed
     request equal to the same request served alone, bulk admission equal
     to token-wise admission; the card against the plain versions on a CPU
     copy cut to 2 layers (prefill of 16 tokens + 2 decode steps); then the
     admission of a 64-token prompt, one decode step at 8 active slots
     (CUDA events and host clock), a profiler window of 3 decode steps
     (``chiprun_out/trace_gemma.json``: kernels by name, idle share, the
     matmul kernel against the LM head's product), and per LM linear shape
     the kernel, its plain version, ``x @ W_hat`` and the bound;
  8. training, after phase 7's model is freed: (a) the paper's Table II
     pipeline on CNN-A (``tools/torch_train_cnn_a.py``: 300 fp32 AdamW steps
     at 1e-3, Algorithm 2 with K_iters 25, 150 STE steps at 1e-4, batch 64,
     512 eval images), then ``deploy.execute`` of the retrained weights on
     ``binary_conv`` and ``binary_matmul``: both losses fall (last 20 steps
     against the first 20), execute's logits within rtol 1e-4 / atol
     1e-4·max|logit| of the fake-quant forward, the deployed accuracy within
     0.02 of the retrained one, 2 + 3 launches; (b) gemma-2b at full width
     and depth in bf16 with remat, fake-quant M=2, K_iters 8, three
     ``build_train_step`` steps at 8 x 64 tokens (1 warm, 2 timed): losses
     finite, every leaf's moments moved, every weight leaf changed (a norm
     scale at 1.0 does not move in bf16 at this warmup's lr); Algorithm 2
     timed alone over the 126 linears, and the peak memory; (c) ``Trainer``
     at reduced(gemma_2b), fp32, deterministic algorithms: a run killed at
     step 5 and resumed ends ``torch.equal`` to the uninterrupted one, one
     injected non-finite loss is skipped and counted (checkpoints in
     ``chiprun_out/train_ckpt/``);
  9. the verification tier: (a) fuzz: 128 random networks
     (``testing/fuzz.random_network`` seeds 0-127, the JAX package's draws)
     compiled on the card with zero verifier ERRORs, ``execute`` at each
     network's execute batch and m_active None and 1 torch.equal to the
     per-call kernel path (each layer through ``kernels.ops`` with its own
     plan pick) and within rtol 1e-4 / atol 1e-4·max|logit| of
     ``execute_reference``; every rare shape drawn at least once (pool 3,
     kh != kw, stride 2 with a pool, VALID, C not a multiple of 8, 1x1 at
     stride 2, depth-wise stride 2, M = 1, an execute batch over the
     compiled one); (b) ``trace_lint`` on phases 2-3's programs: no library
     conv or product, plan pick or float64 at m_active None, 1 and per
     layer, and one launch per instruction over 3 repeats; (c) soaks
     through ``run_soak`` + ``assert_flat`` at the JAX defaults, every
     gauge (live device bytes included) exactly flat after warmup: the
     executor over CNN-A and MobileNetV1-224 at batch 16 (520 steps),
     ``CNNService`` under fault storms (324 steps, every injected fault
     reconciled), the checkpoint cycle (120 steps), ``Server`` on reduced
     gemma-2b (1100 steps, >= 2000 decode steps) and on reduced
     h2o-danube, qwen3 and codeqwen (200 steps each), each server's first
     4 rounds equal to the same scenario on the CPU (tokens; logits within
     rtol 2e-5 / atol 5e-5).  Trend CSVs go to ``chiprun_out/soak/``.

Weights are random, drawn from a seeded generator.  The logits of phases 2
and 3 are compared with rtol 1e-4 and atol 1e-4·max|logit| (a relative
floor: the reference's random MobileNet init shrinks activations to ~1e-13
by the head, and 28 layers of fp32 sums run in another order on each side).

Prints a ``{"kernels": [...]}`` JSON line (``launches`` counts the main
paths of phases 2, 3, 7, 8a, 9a and 9c, ``cnn_launches`` phases 2-3,
``serve_launches`` phase 6, ``lm_launches`` phase 7's serving,
``train_launches`` phase 8a's execute, ``fuzz_launches`` phase 9a's
``execute`` calls and ``soak_launches`` phase 9c's soaks), nvidia-smi's
line, and last ``{"ok": true, "device": {...}}``; per-instruction numbers
go to ``chiprun_out/chip_smoke.json``, phase 7's under ``"lm"``, phase 8's
under ``"train"``, phase 9's under ``"verify"``.  Exits non-zero, printing no result,
without a card or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch import deploy
    from repro_torch.core import binarize as bz
    from repro_torch.core.binconv import pad_nhwc
    from repro_torch.core.binlinear import QuantConfig
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.launch import steps as train_steps
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import api, common as cm, transformer as tf
    from repro_torch.kernels.binary_conv import unpack_taps
    from repro_torch.kernels.binary_dwconv import unpack_dw_taps
    from repro_torch.models import cnn
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.serve_cnn import CNNService, default_ladder
    from repro_torch.testing.faults import FaultInjector, FaultPlan, inject_faults
    from repro_torch.analysis import trace_lint, verify_program
    from repro_torch.testing import fuzz
    from repro_torch.testing import scenarios as soak_sc
    from repro_torch.testing.soak import TrendViolation, run_soak
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


LM_BATCH, LM_LEN, LM_BUCKET, LM_NEW = 8, 256, 64, 16
LM_LINEARS = {  # one weight of each LM linear shape, by its path in a layer
    "q/o 2048->2048": ("attn", "wq"), "k/v 2048->256": ("attn", "wk"),
    "gate/up 2048->16384": ("ffn", "w_gate"), "down 16384->2048": ("ffn", "w_down")}


def lm_config():
    """gemma-2b at full width and depth, fp32, M=2 binary linears."""
    return get_config("gemma_2b").replace(
        dtype="float32", quant=QuantConfig(mode="binary", M=2, K_iters=8))


def build_lm(cfg, dev) -> tuple[dict, dict]:
    """Phase 7: the weights drawn on the card from a seeded generator, each
    layer binarized as soon as it is drawn (its fp32 latent weights freed),
    so the 7.9 GB of fp32 layer weights are never held at once."""
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.torch_dtype,
                                         device=dev)}
    layers, bin_s = [], 0.0
    for _ in range(cfg.n_layers):
        fp = tf.init_layer(gen, cfg, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        layers.append(api.binarize_model_params(cfg, fp))
        torch.cuda.synchronize()
        bin_s += time.perf_counter() - t1
        del fp
    params["layers"] = cm.stack_trees(layers)
    params["final_norm"] = cm.init_rmsnorm(cfg.d_model, cfg.torch_dtype, device=dev)
    del layers
    torch.cuda.synchronize()
    leaves = []
    cm.tree_map(leaves.append, params)
    info = {"build_s": time.perf_counter() - t0, "binarize_s": bin_s,
            "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "packed_gb": sum(t.numel() for t in leaves if t.dtype == torch.uint8) / 1e9}
    print(f"phase 7: gemma-2b {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}: built in {info['build_s']:.2f} s, of which binarize "
          f"{bin_s:.2f} s (Algorithm 2, M=2, K_iters 8); packed weights "
          f"{info['packed_gb']:.3f} GB; card memory in use {info['memory_allocated_gb']:.2f} GB "
          f"(peak {info['max_memory_allocated_gb']:.2f} GB)")
    return params, info


def lm_weight(params, name: str, layer: int = 0) -> dict:
    a, w = LM_LINEARS[name]
    return cm.tree_index(params["layers"][a][w], layer)


def lm_requests(cfg) -> list[Request]:
    """The main path's requests: prompts of 5-60 tokens from a seeded
    generator, m_active None, 1 and a per-layer schedule in turn."""
    rng = np.random.default_rng(0)
    sched = tuple(1 + (i % 2) for i in range(cfg.n_layers))
    modes = [None, 1, sched] * 3
    return [Request(prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new_tokens=LM_NEW, m_active=modes[i])
            for i, n in enumerate(rng.integers(5, 61, LM_BATCH))]


def lm_rows(cfg, params) -> list[int]:
    """Every row count T that phase 7 gives the matmul kernel: the decode
    batch, each request's prefill bucket, the first prompt unbucketed, the
    2-layer check's 16 tokens and the timed 64-token bucket, and T = 1."""
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
    reqs = lm_requests(cfg)
    return sorted({1, LM_BATCH, 16, LM_BUCKET, reqs[0].prompt.size - 1,
                   *(srv._padded_len(r.prompt.size - 1) for r in reqs)})


def check_lm_kernels(cfg, params, gen: torch.Generator, dev) -> float:
    """Phase 7: the matmul kernel against its plain version at every LM
    linear shape and every row count of ``lm_rows``, m_active 1 and 2; the
    second plan must give the same bits."""
    max_err, checks = 0.0, 0
    rows = lm_rows(cfg, params)
    for name in LM_LINEARS:
        p = lm_weight(params, name)
        K, N = p["B_packed"].shape[1] * 8, p["B_packed"].shape[2]
        for T in rows:
            if ops.pick_matmul_plan(T, N) == ALT_PLAN["linear"]:
                fail(f"LM {name} T={T}: the picked plan is the second plan")
            x = torch.randn(T, K, generator=gen).to(dev)
            for m in (1, 2):
                kw = dict(K=K, group_size=K, m_active=m)
                got = ops.binary_matmul(x, p["B_packed"], p["alpha"], **kw)
                want = kref.binary_matmul_ref(x, p["B_packed"], p["alpha"], **kw)
                alt = ops.binary_matmul(x, p["B_packed"], p["alpha"], plan=ALT_PLAN["linear"],
                                        **kw)
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                    fail(f"LM {name} T={T} m={m}: kernel vs plain max |d| {err:.3g}")
                if not torch.equal(got, alt):
                    fail(f"LM {name} T={T} m={m}: plans differ")
                checks += 1
    torch.cuda.synchronize()
    print(f"phase 7: {checks} LM-shape kernel-vs-plain checks at T = {rows} passed (rtol "
          f"{RTOL}, atol {ATOL}), second plan bit-identical; max |d| {max_err:.3g}")
    return max_err


def top2_margin(logits: np.ndarray) -> float:
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def same_stream(where: str, a: Request, b: Request, rtol=2e-5, atol=5e-5) -> None:
    """Tokens equal and last logits allclose (the JAX serving tests'
    tolerance); a token mismatch reports the top-2 margin of the logits."""
    if a.out_tokens != b.out_tokens:
        fail(f"{where}: tokens {a.out_tokens} != {b.out_tokens}; top-2 margin of the last "
             f"logits {top2_margin(a.last_logits):.3g} / {top2_margin(b.last_logits):.3g}")
    if not np.allclose(a.last_logits, b.last_logits, rtol=rtol, atol=atol):
        fail(f"{where}: last logits max |d| {np.abs(a.last_logits - b.last_logits).max():.3g}")


def serve_lm(cfg, params, dev) -> dict:
    """Phase 7, the main path: 8 requests through ``Server`` until done.
    Launch counts are set to 0 just before each admission and each step
    and read just after; every decode group step and every bulk admission
    must launch the matmul kernel 18 x 7 times."""
    per_pass = cfg.n_layers * 7
    reqs = lm_requests(cfg)
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
    leaves = []
    cm.tree_map(leaves.append, srv.cache)
    if any(t.device.type != dev.type for t in leaves) or srv.device.type != dev.type:
        fail(f"LM serve: the server or its cache is not on {dev}")
    launches = {k: 0 for k in TPU_KERNELS}

    def counted(fn, want_passes: int, where: str):
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts["binary_matmul"] != want_passes * per_pass or \
                counts["binary_conv"] or counts["binary_dwconv"]:
            fail(f"LM serve {where}: launches {counts}, want {want_passes} x {per_pass} "
                 f"matmul launches")
        for k, v in counts.items():
            launches[k] += v

    t0 = time.perf_counter()
    for r in reqs:
        counted(lambda: srv.admit(r) or fail("LM serve: admission refused"), 1, "admit")
    rounds = 0
    while any(s is not None for s in srv.slots):
        before = srv.stats["decode_steps"]
        ops.reset_launch_counts()
        srv.step()
        torch.cuda.synchronize()
        groups = srv.stats["decode_steps"] - before
        n = ops.launch_counts()["binary_matmul"]
        if n != groups * per_pass:
            fail(f"LM serve: a round of {groups} group steps launched the matmul {n} times, "
                 f"want {groups} x {per_pass}")
        launches["binary_matmul"] += n
        rounds += 1
    serve_s = time.perf_counter() - t0
    for r in reqs:
        if not r.done or len(r.out_tokens) != LM_NEW or r.last_logits.shape != (cfg.vocab,) \
                or not np.isfinite(r.last_logits).all() \
                or not all(0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"LM serve: request of {r.prompt.size} tokens ended with {r.out_tokens}")
    print(f"phase 7: served {len(reqs)} requests (prompts {[r.prompt.size for r in reqs]}, "
          f"m_active None/1/per-layer) in {rounds} rounds, {serve_s:.2f} s; stats "
          f"{srv.stats}; configs {srv.cache_sizes()}; {per_pass} matmul launches per "
          f"admission and per decode group step")

    # a request of each mode served alone gives the stream it got in the mix
    for r in reqs[:3]:
        solo = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
        again = Request(prompt=r.prompt.copy(), max_new_tokens=LM_NEW, m_active=r.m_active)
        solo.admit(again)
        solo.run_until_done()
        same_stream(f"LM serve: m_active {r.m_active} alone vs in the mix", again, r)
    # bulk admission == token-wise admission
    streams = {}
    for mode in ("bulk", "tokenwise"):
        one = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN, prefill=mode,
                     prefill_buckets=None)
        streams[mode] = Request(prompt=reqs[0].prompt.copy(), max_new_tokens=4)
        one.admit(streams[mode])
        one.run_until_done()
    same_stream("LM serve: bulk vs token-wise admission", streams["bulk"],
                streams["tokenwise"])
    print(f"phase 7: each mode served alone gave the tokens it got in the mix; bulk "
          f"admission of {reqs[0].prompt.size} tokens gave token-wise admission's tokens "
          f"{streams['bulk'].out_tokens} and logits (rtol 2e-5, atol 5e-5)")
    return {"stats": srv.stats, "rounds": rounds, "serve_s": serve_s, "launches": launches,
            "prompt_lens": [int(r.prompt.size) for r in reqs],
            "out_tokens": [r.out_tokens for r in reqs]}


def lm_card_vs_plain(cfg, params, dev) -> dict:
    """Phase 7: the card against the plain versions, the same weights cut to
    2 layers at full width: prefill of 16 tokens and 2 decode steps, the
    port's functions on the card and on a CPU copy of the params."""
    cfg2 = cfg.replace(n_layers=2)
    card = {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": cm.tree_map(lambda t: t[:2], params["layers"])}
    host = cm.tree_map(lambda t: t.cpu(), card)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 16)).astype(np.int64))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1, 1)).astype(np.int64))
    outs = {}
    for where, p in (("card", card), ("plain", host)):
        d = p["embed"]["table"].device
        logits, cache = api.prefill(cfg2, p, toks.to(d), max_len=32)
        got = [logits.cpu()]
        for i in range(2):
            pos = torch.full((1,), 16 + i, dtype=torch.int32, device=d)
            lg, cache = api.decode_step(cfg2, p, {"tokens": steps[i].to(d), "pos": pos,
                                                  "cache": cache})
            got.append(lg.cpu())
        leaves = []
        cm.tree_map(lambda t: leaves.append(t.cpu()), cache)
        outs[where] = (got, leaves)
    worst = 0.0
    for what, a, b in [("logits", x, y) for x, y in zip(outs["card"][0], outs["plain"][0])] \
            + [("cache", x, y) for x, y in zip(outs["card"][1], outs["plain"][1])]:
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if not torch.isfinite(a).all() or scale == 0.0 or \
                not torch.allclose(a, b, rtol=1e-4, atol=1e-4 * scale):
            fail(f"LM card vs plain ({what}): max |d| {err:.3g}, max |plain| {scale:.3g}")
    print(f"phase 7: 2 layers at full width, prefill of 16 tokens + 2 decode steps: card "
          f"within rtol 1e-4 / atol 1e-4·max|x| of the plain versions on the CPU (logits and "
          f"every cache leaf); worst max|d|/max|x| {worst:.3g}")
    return {"worst_rel_err": worst}


def lm_timing(cfg, params, gen: torch.Generator, dev, out_dir: Path) -> dict:
    """Phase 7 timings: admission of a 64-token prompt, a decode step at 8
    active slots, a profiler window of 3 decode steps, and the LM linears
    one by one (``time_lm_linears``)."""
    rng = np.random.default_rng(2)
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
    prompt = rng.integers(0, cfg.vocab, LM_BUCKET).astype(np.int32)
    admit_ms = []
    for i in range(6):
        srv.slots = [None] * LM_BATCH
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.admit(Request(prompt=prompt.copy(), max_new_tokens=LM_NEW))
        torch.cuda.synchronize()
        if i:
            admit_ms.append((time.perf_counter() - t0) * 1e3)
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
    for _ in range(LM_BATCH):
        srv.admit(Request(prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                          max_new_tokens=LM_LEN - 16))
    host_ms, dev_ms = [], []
    for i in range(12):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        srv.step()
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        if i >= 2:
            host_ms.append((t1 - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
    picks = ops.plan_pick_count()
    srv.step()
    picks = ops.plan_pick_count() - picks
    step = {"admit_64_ms": statistics.median(admit_ms), "admit_64_all_ms": admit_ms,
            "decode_step_host_ms": statistics.median(host_ms),
            "decode_step_events_ms": statistics.median(dev_ms),
            "decode_steps_host_ms": host_ms, "plan_picks_per_decode_step": picks}
    step["tokens_per_s"] = LM_BATCH / step["decode_step_host_ms"] * 1e3
    print(f"phase 7: admission of a {LM_BUCKET}-token prompt (prefill at bucket "
          f"{srv._padded_len(LM_BUCKET - 1)} + scatter) median {step['admit_64_ms']:.3f} ms; "
          f"decode step at {LM_BATCH} active slots median {step['decode_step_host_ms']:.3f} ms "
          f"host clock, {step['decode_step_events_ms']:.3f} ms CUDA events "
          f"({step['tokens_per_s']:.1f} tokens/s); {picks} plan picks per step")

    from torch.profiler import ProfilerActivity, profile, schedule
    path = out_dir / "trace_gemma.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=3, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(4):
            srv.step()
            torch.cuda.synchronize()
            prof.step()
    split = device_split(json.loads(path.read_text())["traceEvents"])
    mm_us = sum(us for n, us in split["device_us_by_name"].items() if "binary_matmul" in n)
    head_us = sum(e.device_time_total for e in prof.key_averages(group_by_input_shape=True)
                  if e.key == "aten::mm" and any(cfg.vocab in (s or []) for s in e.input_shapes))
    if mm_us == 0 or head_us == 0:
        fail(f"LM profile: binary_matmul {mm_us} us, LM head {head_us} us")
    split.update(binary_matmul_us_per_step=mm_us / 3, lm_head_us_per_step=head_us / 3)
    print(f"phase 7: profiler over 3 decode steps: window {split['window_us'] / 3e3:.4f} ms "
          f"per step, device busy {split['busy_us'] / 3e3:.4f} ms, idle share "
          f"{split['idle_share']:.4f}; binary_matmul {mm_us / 3e3:.4f} ms and LM head "
          f"{head_us / 3e3:.4f} ms of device time per step; trace {path.relative_to(ROOT)}")
    for name, us in list(split["device_us_by_name"].items())[:10]:
        print(f"  {us / 3e3:.5f} ms per step  {name[:110]}")
    return {**step, "profile": split, "linears": time_lm_linears(params, gen, dev)}


def time_lm_linears(params, gen: torch.Generator, dev) -> list:
    """Per LM linear shape at T = 8 (decode) and 64 (the prefill bucket),
    m_active 2: the kernel, its plain version and ``x @ W_hat`` (CUDA graphs)
    and the bound."""
    rows = []
    for name in LM_LINEARS:
        p = lm_weight(params, name)
        K, N = p["B_packed"].shape[1] * 8, p["B_packed"].shape[2]
        W_hat = bz.reconstruct(bz.BinApprox(bz.unpack_bits(p["B_packed"], K), p["alpha"], K))
        for T in (LM_BATCH, LM_BUCKET):
            x = torch.randn(T, K, generator=gen).to(dev)
            kw = dict(K=K, group_size=K)
            ms = graph_ms(lambda: ops.binary_matmul(x, p["B_packed"], p["alpha"], **kw))
            plain_ms = graph_ms(lambda: kref.binary_matmul_ref(x, p["B_packed"], p["alpha"],
                                                               **kw), reps=3)
            lib_ms = graph_ms(lambda: x @ W_hat)
            nbytes = 4 * T * K + p["B_packed"].numel() + 4 * p["alpha"].numel() + 4 * T * N
            flops = 2 * T * K * N
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
            rows.append({"shape": name, "T": T, "K": K, "N": N,
                         "plan": list(ops.pick_matmul_plan(T, N)), "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                         "bytes": nbytes, "flops": flops})
            print(f"  LM {name} T={T} plan {tuple(rows[-1]['plan'])}: kernel {ms:.5f} ms, "
                  f"plain {plain_ms:.5f} ms, x @ W_hat {lib_ms:.5f} ms, bound "
                  f"{rows[-1]['bound_ms']:.5f} ms ({rows[-1]['bound_by']})")
    return rows


def lm_phase(gen: torch.Generator, dev, out_dir: Path) -> dict:
    """Phase 7: gemma-2b on the card through the port's LM stack and Server."""
    cfg = lm_config()
    t0 = time.time()
    params, build = build_lm(cfg, dev)
    max_err = check_lm_kernels(cfg, params, gen, dev)
    served = serve_lm(cfg, params, dev)
    plain = lm_card_vs_plain(cfg, params, dev)
    timing = lm_timing(cfg, params, gen, dev, out_dir)
    print(f"phase 7: {time.time() - t0:.1f} s")
    return {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype, "M": 2},
            "build": build, "max_abs_err": max_err, "serve": served,
            "card_vs_plain": plain, "timing": timing}


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 3     # phase 8b: 1 warm step, 2 timed


def last_vs_first(where: str, losses: list, n: int = 20) -> tuple[float, float]:
    """Mean of the first and the last ``n`` losses; fails unless it fell."""
    first, last = statistics.mean(losses[:n]), statistics.mean(losses[-n:])
    if not last < first:
        fail(f"{where}: mean loss of the last {n} steps {last:.4f} is not below that of "
             f"the first {n}, {first:.4f}")
    return first, last


def train_cnn_a(dev) -> dict:
    """Phase 8a: the paper's Table II pipeline on CNN-A at full width
    (``tools/torch_train_cnn_a.py``): fp32 training, Algorithm 2, STE
    retraining, then ``deploy.execute`` of the retrained network on the
    ``binary_conv`` and ``binary_matmul`` kernels (counts reset just before
    that call, read just after)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_train_cnn_a as table2_tool

    t0 = time.time()
    out = table2_tool.table2(steps=300, M=2, eval_n=512, batch=64, device=dev)
    fp = last_vs_first("8a fp32 training", out["fp_losses"])
    rt = last_vs_first("8a STE retraining", out["rt_losses"])
    want, got = out["logits_fake_quant"], out["logits_deploy"]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or not torch.allclose(got, want, rtol=1e-4,
                                                                 atol=1e-4 * scale):
        fail(f"8a: execute's logits vs the fake-quant forward max |d| {err:.3g} "
             f"(max |logit| {scale:.3g})")
    if abs(out["acc_deploy"] - out["acc_rt"]) > 0.02:
        fail(f"8a: deployed accuracy {out['acc_deploy']:.4f} is not within 0.02 of the "
             f"retrained fake-quant accuracy {out['acc_rt']:.4f}")
    if out["launches"] != EXPECTED_LAUNCHES["cnn_a"]:
        fail(f"8a: execute launched {out['launches']}, not {EXPECTED_LAUNCHES['cnn_a']}")
    # Algorithm 2 alone over the five layers, as one fake-quant forward runs it
    alg2 = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for spec in cnn.CNN_A_SPECS:
            w = out["params_rt"][spec.name]["w"]
            with torch.no_grad():
                bz.reconstruct(bz.algorithm2(w.reshape(-1, w.shape[-1]), 2, K_iters=25))
        torch.cuda.synchronize()
        alg2.append(time.perf_counter() - t1)
    res = {k: out[k] for k in ("acc_fp", "acc_bin", "acc_rt", "acc_deploy", "compression",
                               "eq6", "fp_step_ms", "rt_step_ms", "compile_s", "launches")}
    res.update(fp_loss_first_last=fp, rt_loss_first_last=rt, logits_max_abs_err=err,
               max_abs_logit=scale, algorithm2_ms=1e3 * statistics.median(alg2),
               seconds=time.time() - t0)
    print(f"phase 8a: CNN-A Table II on the card: accuracy fp32 {out['acc_fp']:.4f}, "
          f"binarized (Algorithm 2, M=2) {out['acc_bin']:.4f}, retrained {out['acc_rt']:.4f}, "
          f"deployed {out['acc_deploy']:.4f}; compression {out['compression']:.2f}x; mean "
          f"loss first/last 20 steps {fp[0]:.4f}/{fp[1]:.4f} (fp32), {rt[0]:.4f}/{rt[1]:.4f} "
          f"(STE); median step {out['fp_step_ms']:.3f} ms fp32, {out['rt_step_ms']:.3f} ms "
          f"fake-quant, of which Algorithm 2 alone {res['algorithm2_ms']:.3f} ms; execute vs "
          f"fake-quant max |d| {err:.3g} (max |logit| {scale:.4g}); "
          f"launches {out['launches']}; {res['seconds']:.1f} s")
    return res


def train_lm_config():
    """gemma-2b at full width and depth in its own dtype (bf16) and remat,
    fake-quant binary linears, M=2, K_iters 8."""
    cfg = get_config("gemma_2b")
    return cfg.replace(quant=QuantConfig(mode="fake_quant", M=2, K_iters=8))


def train_gemma(dev) -> dict:
    """Phase 8b: three ``build_train_step`` steps of gemma-2b at full width
    (1 warm, 2 timed), every loss finite, every leaf's moments moved; the
    params' changes, Algorithm 2's share of a step and the peak memory."""
    cfg = train_lm_config()
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw(warmup_cosine(3e-4, 10, TRAIN_STEPS))
    state = train_steps.init_train_state(cfg, opt, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in cm.tree_leaves(state["params"]))
    before = [t.to("cpu", copy=True) for t in cm.tree_leaves(state["params"])]
    step_fn = train_steps.build_train_step(cfg, opt)
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=dev)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        batch = data.next_batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
        if metrics["skipped"] or not math.isfinite(losses[-1]):
            fail(f"8b: step {len(losses) - 1} loss {losses[-1]} is not finite")
    peak = torch.cuda.max_memory_allocated()
    changed = {}
    paths = param_paths(state["params"])
    for path, old, new, mu in zip(paths, before, cm.tree_leaves(state["params"]),
                                  cm.tree_leaves(state["opt_state"]["mu"])):
        if not bool(torch.isfinite(mu).all()) or not bool((mu != 0).any()):
            fail(f"8b: the moments of {path} did not move (no gradient reached it)")
        changed[path] = float((new.cpu() != old).float().mean())
    frozen = [p for p, f in changed.items() if f == 0.0]
    if [p for p in frozen if not p.endswith("scale")]:
        fail(f"8b: these weight leaves did not change: {frozen}")
    # Algorithm 2 alone over the 126 binary linears (one forward's worth)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_lin = 0
    for path, leaf in zip(paths, cm.tree_leaves(state["params"])):
        if leaf.ndim == 3:
            for w in leaf:
                with torch.no_grad():
                    bz.reconstruct(bz.algorithm2(w.to(torch.float32), 2, K_iters=8))
                n_lin += 1
    torch.cuda.synchronize()
    alg2_s = time.perf_counter() - t1
    step_ms = 1e3 * statistics.median(step_s[1:])
    res = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
                      "remat": cfg.remat, "M": 2, "K_iters": 8, "batch": TRAIN_BATCH,
                      "seq": TRAIN_SEQ},
           "n_params": n_params, "init_s": init_s, "losses": losses,
           "step_ms": [1e3 * s for s in step_s], "median_step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "algorithm2_linears": n_lin, "algorithm2_s": alg2_s,
           "algorithm2_share": 2 * alg2_s / (step_ms / 1e3),
           "max_memory_allocated_gb": peak / 1e9, "changed_fraction": changed,
           "unchanged_leaves": frozen, "seconds": time.time() - t0}
    print(f"phase 8b: gemma-2b {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}, remat {cfg.remat}, fake-quant M=2: {n_params} "
          f"params, state built in {init_s:.1f} s; losses {[round(x, 4) for x in losses]}; "
          f"median step {step_ms:.1f} ms ({res['tokens_per_s']:.1f} tokens/s) of "
          f"{[round(1e3 * s, 1) for s in step_s]} ms; Algorithm 2 alone over {n_lin} linears "
          f"{alg2_s:.3f} s, twice per step under remat = {res['algorithm2_share']:.3f} of a "
          f"step; max_memory_allocated {peak / 1e9:.2f} GB; leaves unchanged in bf16 "
          f"{frozen}; {res['seconds']:.1f} s")
    return res


def param_paths(tree, prefix="") -> list:
    """'/'-joined paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in param_paths(tree[k], f"{prefix}/{k}")]
    return [prefix.lstrip("/")]


@contextlib.contextmanager
def nan_on_call(n: int):
    """``api.loss_fn`` returns a non-finite loss on its n-th call (the
    injected fault of phase 8c), the real one before and after."""
    real, calls = api.loss_fn, {"n": 0}

    def patched(cfg, params, batch):
        loss, metrics = real(cfg, params, batch)
        calls["n"] += 1
        if calls["n"] == n:
            loss = loss * float("nan")
            metrics = dict(metrics, loss=loss)
        return loss, metrics

    api.loss_fn = patched
    try:
        yield
    finally:
        api.loss_fn = real


def train_resume(dev, out_dir: Path) -> dict:
    """Phase 8c: ``Trainer`` on the card at reduced(gemma_2b), fp32, with
    deterministic algorithms: 10 steps checkpointed at 5 and 10; a run killed
    at 5 and resumed by a fresh Trainer ends with the same embedding table
    (torch.equal); one injected non-finite loss is skipped and counted."""
    cfg = reduced(get_config("gemma_2b")).replace(dtype="float32")
    root = out_dir / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()

    def trainer(name: str, total: int) -> Trainer:
        opt = adamw(1e-3)
        return Trainer(train_steps.build_train_step(cfg, opt),
                       train_steps.init_train_state(cfg, opt, device=dev),
                       SyntheticTokens(cfg.vocab, 16, 4, seed=0, device=dev),
                       TrainerConfig(total_steps=total, checkpoint_every=5,
                                     checkpoint_dir=str(root / name), log_every=100))

    torch.use_deterministic_algorithms(True)
    try:
        full = trainer("full", 10)
        full.run()
        trainer("killed", 5).run()
        resumed = trainer("killed", 10)
        if not resumed.maybe_resume() or resumed.report.resumed_from != 5:
            fail(f"8c: no resume from step 5 (resumed_from {resumed.report.resumed_from})")
        resumed.run()
        a, b = full.state["params"]["embed"]["table"], resumed.state["params"]["embed"]["table"]
        if not torch.equal(a, b):
            fail(f"8c: the resumed run's embedding table differs, max |d| "
                 f"{float((a - b).abs().max()):.3g}")
        guarded = trainer("nan", 3)
        with nan_on_call(2):
            report = guarded.run()
        if report.nan_skips != 1 or int(guarded.state["step"]) != 2:
            fail(f"8c: nan_skips {report.nan_skips}, step {int(guarded.state['step'])} "
                 "(want 1 and 2)")
    finally:
        torch.use_deterministic_algorithms(False)
    res = {"losses": full.report.losses, "resumed_losses": resumed.report.losses,
           "nan_skips": report.nan_skips, "seconds": time.time() - t0}
    print(f"phase 8c: Trainer on the card (reduced gemma-2b, fp32, deterministic): 10 steps, "
          f"loss {full.report.losses[0]:.4f} -> {full.report.losses[-1]:.4f}; killed at 5 and "
          f"resumed: embedding table torch.equal; one injected NaN skipped (nan_skips "
          f"{report.nan_skips}); {res['seconds']:.1f} s")
    return res


def train_phase(dev, out_dir: Path) -> dict:
    """Phase 8: training on the card (8a CNN-A, 8b gemma-2b, 8c Trainer)."""
    t0 = time.time()
    cnn_a = train_cnn_a(dev)
    gemma = train_gemma(dev)
    gc.collect()
    torch.cuda.empty_cache()
    resume = train_resume(dev, out_dir)
    print(f"phase 8: {time.time() - t0:.1f} s")
    return {"cnn_a": cnn_a, "gemma": gemma, "trainer": resume}


# ---------------------------------------------------------------------------
# Phase 9: the verification tier
# ---------------------------------------------------------------------------

FUZZ_SEEDS = range(128)        # include the JAX package's pinned 0, 3, 6, 11
MOBILENET_B2 = {"width_mult": 1.0, "n_classes": 1000, "resolution": 224}
SOAK_STEPS = {"executor": 520, "cnn_server": 324, "checkpoint": 120, "server": 1100}
SOAK_FAMILIES = ("h2o_danube_1_8b", "qwen3_14b", "codeqwen15_7b")  # 200 steps each
FAMILY_STEPS, PARITY_ROUNDS = 200, 4


def counted_launches(fn, into: dict):
    """Run ``fn`` with every launch count set to 0 just before it and add
    the counts read just after into ``into``."""
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    for k, v in ops.launch_counts().items():
        into[k] += v
    return out


def fuzz_phase(dev) -> dict:
    """Phase 9a: random networks through the three kernels.  Each seed's
    network is compiled on the card and verified (zero ERRORs), then
    ``execute`` at its execute batch, m_active None and 1 (the counted main
    path, one launch per instruction), is held torch.equal to the per-call
    kernel path (``fuzz.kernel_forward``: each layer with its own plan pick)
    and within rtol 1e-4 / atol 1e-4·max|logit| of ``execute_reference``."""
    t0 = time.time()
    launches = {k: 0 for k in TPU_KERNELS}
    covered = {f: [] for f in fuzz.FEATURES}
    worst = 0.0
    for seed in FUZZ_SEEDS:
        net = fuzz.random_network(seed)
        where = f"9a: seed {seed} ({[s.name for s in net.specs]} @ {net.input_shape}, " \
                f"exec batch {net.exec_batch}, M {net.M})"
        qc = QuantConfig(mode="binary", M=net.M, K_iters=2)
        packed = cnn.spec_binarize(
            net.specs, net.init_params(torch.Generator().manual_seed(seed), device=dev), qc)
        prog = deploy.compile(packed, net.specs, qc, net.input_shape, device=dev,
                              golden=False)
        errors = [f for f in verify_program(prog) if f.severity == "ERROR"]
        if errors:
            fail(f"{where}: verifier ERRORs {[str(f) for f in errors[:3]]}")
        per_call = {k: 0 for k in TPU_KERNELS}
        for i in prog.instrs:
            per_call[KERNEL_OF[i.kind]] += 1
        x = torch.randn((net.exec_batch,) + net.input_shape[1:],
                        generator=torch.Generator().manual_seed(seed + 99)).to(dev)
        for m in (None, 1):
            before = dict(launches)
            got = counted_launches(lambda: deploy.execute(prog, x, m), launches)
            if {k: launches[k] - before[k] for k in launches} != per_call:
                fail(f"{where} m_active={m}: launches {launches} (from {before}), want "
                     f"{per_call} more")
            if not torch.equal(got, fuzz.kernel_forward(net.specs, packed, x, m)):
                fail(f"{where} m_active={m}: execute is not torch.equal to the per-call "
                     f"kernel path")
            want = deploy.execute_reference(prog, x, m)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            if not bool(torch.isfinite(got).all()) or \
                    not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
                fail(f"{where} m_active={m}: max |d| vs plain {err:.3g} (max |logit| "
                     f"{scale:.3g})")
            worst = max(worst, err / max(scale, 1e-30))
        for f in fuzz.features(net):
            covered[f].append(seed)
    missing = [f for f, seeds in covered.items() if not seeds]
    if missing or any(v == 0 for v in launches.values()):
        fail(f"9a: features never drawn {missing} or a kernel never launched {launches}")
    res = {"seeds": len(FUZZ_SEEDS), "launches": launches, "worst_rel_err": worst,
           "features": {f: len(s) for f, s in covered.items()},
           "first_seed": {f: s[0] for f, s in covered.items()}, "seconds": time.time() - t0}
    print(f"phase 9a: {len(FUZZ_SEEDS)} fuzz networks compiled, verified (0 ERRORs), "
          f"executed at m_active None and 1: torch.equal to the per-call kernel path, "
          f"within rtol 1e-4 of the plain path (worst max|d|/max|logit| {worst:.3g}); "
          f"features {res['features']}; launches {launches}; {res['seconds']:.1f} s")
    return res


def lint_phase(programs: dict, inputs: dict) -> dict:
    """Phase 9b: the trace lint of phases 2-3's programs on the card."""
    out = {}
    for arch, program in programs.items():
        x = inputs[arch]
        scheds = (None, 1, [1 + (i % 2) for i in range(len(program))])
        fs = [f for m in scheds for f in trace_lint.lint_execute(program, x, m_active=m)]
        seen, _, _ = trace_lint.record_ops(lambda: deploy.execute(program, x), ())
        fs += trace_lint.retrace_findings(program, x, schedules=scheds, repeats=3)
        if fs:
            fail(f"9b: {arch}: {[str(f) for f in fs]}")
        out[arch] = {"findings": 0, "aten_ops_per_call": dict(sorted(seen.items()))}
        print(f"phase 9b: {arch}: lint_execute at m_active None, 1 and per layer, and "
              f"retrace over 3 repeats: 0 findings; aten ops of one call "
              f"{out[arch]['aten_ops_per_call']}")
    return out


def server_rounds(scen, rounds: int) -> list:
    """Drive a server scenario ``rounds`` steps; after each, every admitted
    request's tokens so far and last logits."""
    srv, admitted = scen.subject, []
    admit = srv.admit

    def recording(req):
        admitted.append(req)
        return admit(req)

    srv.admit = recording
    out = []
    try:
        for i in range(1, rounds + 1):
            scen.step(i)
            out.append([(list(r.out_tokens), None if r.last_logits is None
                         else r.last_logits.copy()) for r in admitted])
    finally:
        del srv.admit       # the wrapper and the server form a reference cycle
    return out


def family_parity(family: str, dev) -> int:
    """The first decode rounds of a server scenario on the card against the
    same scenario on the CPU: tokens equal, logits within phase 7's rtol
    2e-5 / atol 5e-5.  Returns the number of requests compared."""
    card = server_rounds(soak_sc.server_scenario(family=family, device=dev), PARITY_ROUNDS)
    host = server_rounds(soak_sc.server_scenario(family=family, device="cpu"),
                         PARITY_ROUNDS)
    for rnd, (a, b) in enumerate(zip(card, host), 1):
        if len(a) != len(b):
            fail(f"9c: {family} round {rnd}: {len(a)} requests on the card, {len(b)} on "
                 f"the CPU")
        for j, ((ta, la), (tb, lb)) in enumerate(zip(a, b)):
            if ta != tb:
                fail(f"9c: {family} round {rnd} request {j}: tokens {ta} != {tb}; top-2 "
                     f"margin {top2_margin(la):.3g} / {top2_margin(lb):.3g}")
            if (la is None) != (lb is None) or (
                    la is not None and not np.allclose(la, lb, rtol=2e-5, atol=5e-5)):
                fail(f"9c: {family} round {rnd} request {j}: logits differ "
                     f"(max |d| {np.abs(la - lb).max():.3g})")
    return len(card[-1])


def soak_one(name: str, scen, steps: int, csv_dir: Path, launches: dict) -> dict:
    """``run_soak`` + ``assert_flat`` at the JAX defaults; the soak's
    launches are counted.  Garbage of earlier phases is collected first, so
    the cycle collector frees none of it inside the soak's window."""
    gc.collect()
    t0 = time.time()
    result = counted_launches(
        lambda: run_soak(scen.step, steps=steps, name=name, gauges=scen.gauges), launches)
    result.write_csv(str(csv_dir / f"{name}_trend.csv"))
    try:
        result.assert_flat()
    except TrendViolation as e:
        fail(f"9c: {e}")
    progress = scen.progress()
    res = {"steps": steps, "seconds": time.time() - t0, "summary": result.summary(),
           "gauges": sorted(scen.gauges), "progress": progress,
           "median_step_ms": float(np.median(result.latency)) * 1e3}
    print(f"phase 9c: {result.summary()}; FLAT; gauges {res['gauges']}; median step "
          f"{res['median_step_ms']:.3f} ms; {res['seconds']:.1f} s")
    return res


def soak_phase(dev, out_dir: Path) -> dict:
    """Phase 9c: each scenario through run_soak + assert_flat, with the
    acceptance floors and reconciliations of the JAX soak tests."""
    t0 = time.time()
    csv_dir = out_dir / "soak"
    ckpt_dir = out_dir / "soak_ckpt"
    for d in (csv_dir, ckpt_dir):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    launches = {k: 0 for k in TPU_KERNELS}
    out = {}

    scen = soak_sc.executor_scenario(batch=16, mobilenet_kw=MOBILENET_B2, device=dev)
    if "exec_live_bytes" not in scen.gauges:
        fail("9c: the executor scenario gauges no live device bytes on the card")
    out["executor"] = soak_one("executor", scen, SOAK_STEPS["executor"], csv_dir, launches)
    if out["executor"]["progress"]["execute_calls"] < 500:
        fail(f"9c: executor: {out['executor']['progress']}")

    scen = soak_sc.cnn_server_scenario(directory=str(ckpt_dir / "cnn_server"), device=dev)
    out["cnn_server"] = soak_one("cnn_server", scen, SOAK_STEPS["cnn_server"], csv_dir,
                                 launches)
    p = scen.progress()
    st, inj = p["stats"], p["injected"]
    checks = {
        "verified > 100, 0 mismatches": p["verified"] > 100 and p["mismatches"] == 0,
        "errors injected == observed": st["exec_exceptions"] == inj["error"] > 0,
        "NaN/Inf injected == observed": st["nonfinite_detected"] == inj["nan"] + inj["inf"]
        and inj["nan"] > 0 and inj["latency"] > 0,
        "retried, nothing failed": st["retries"] > 0 and st["exec_failed_batches"] == 0
        and p["failed"] == 0,
        "reduced-M rungs and rung 0 served": st["rung_hist"].get(0, 0) > 0
        and sum(v for k, v in st["rung_hist"].items() if k > 0) > 0,
        "back to rung 0, not shedding": st["rung"] == 0 and not st["shedding"],
        "sheds at dispatch and admit": st["shed"]["deadline_expired"] > 0
        and st["shed"]["slo_shed"] > 0,
        "queue drained": st["queue_depth"] <= 2 * 4,
        "reloads == memory flips": st["reloads"] == inj["bitflip_mem"] > 0
        and st["selftest_failures"] == inj["bitflip_mem"],
        "quarantines == disk flips": st["quarantined_steps"] == p["ckpt_quarantined"]
        == inj["bitflip_disk"] > 0,
        "self-tests passed too": st["selftest_runs"] > st["selftest_failures"],
        "schedules within the ladder": len(scen.subject._schedules_seen)
        <= len(scen.subject.controller.ladder),
    }
    if not all(checks.values()):
        fail(f"9c: cnn_server reconciliation {[k for k, v in checks.items() if not v]}: {p}")
    print(f"phase 9c: cnn_server reconciled: {list(checks)}")

    scen = soak_sc.checkpoint_scenario(str(ckpt_dir / "checkpoint"), device=dev)
    out["checkpoint"] = soak_one("checkpoint", scen, SOAK_STEPS["checkpoint"], csv_dir,
                                 launches)
    if out["checkpoint"]["progress"]["cycles"] < 120 or \
            out["checkpoint"]["progress"]["ckpt_dirs"] > 2:
        fail(f"9c: checkpoint: {out['checkpoint']['progress']}")

    scen = soak_sc.server_scenario(device=dev)
    out["server"] = soak_one("server", scen, SOAK_STEPS["server"], csv_dir, launches)
    st = out["server"]["progress"]
    if st["decode_steps"] < 2000 or st["bulk_prefills"] <= 100:
        fail(f"9c: server: {st}")
    out["server"]["parity_requests"] = family_parity("gemma_2b", dev)

    for family in SOAK_FAMILIES:
        out[family] = soak_one(f"server_{family}",
                               soak_sc.server_scenario(family=family, device=dev),
                               FAMILY_STEPS, csv_dir, launches)
        out[family]["parity_requests"] = family_parity(family, dev)
        print(f"phase 9c: {family}: the first {PARITY_ROUNDS} rounds' tokens equal and "
              f"logits within rtol 2e-5 / atol 5e-5 of the CPU copy "
              f"({out[family]['parity_requests']} requests)")
    if any(v == 0 for v in launches.values()):
        fail(f"9c: a kernel never launched in the soaks: {launches}")
    out["launches"] = launches
    out["seconds"] = time.time() - t0
    print(f"phase 9c: every soak FLAT (gauges exactly flat, live device bytes included); "
          f"launches {launches}; trend CSVs in {csv_dir.relative_to(ROOT)}; "
          f"{out['seconds']:.1f} s")
    return out


def verify_phase(programs: dict, inputs: dict, dev, out_dir: Path) -> dict:
    """Phase 9: fuzz (9a), lint (9b) and soak (9c)."""
    t0 = time.time()
    res = {"fuzz": fuzz_phase(dev), "lint": lint_phase(programs, inputs),
           "soak": soak_phase(dev, out_dir)}
    res["seconds"] = time.time() - t0
    print(f"phase 9: {res['seconds']:.1f} s")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    # phase 8c's bit-exact resume needs deterministic cuBLAS, whose workspace
    # is fixed by this variable before the first cuBLAS call
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
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
    lm = lm_phase(gen, dev, out_dir)
    gc.collect()                      # phase 7's model is gone: its memory goes back
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = train_phase(dev, out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    verify = verify_phase(programs, inputs, dev, out_dir)
    fuzz_launches, soak_launches = verify["fuzz"]["launches"], verify["soak"]["launches"]

    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        tot = totals[name]
        t_bytes = tot["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = tot["flops"] / FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (launches[name] + lm["serve"]["launches"][name]
                         + train["cnn_a"]["launches"][name] + fuzz_launches[name]
                         + soak_launches[name]),
            "max_abs_err": max(max_err[name], lm["max_abs_err"] if name == "binary_matmul"
                               else 0.0),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tot["library_ms"], "instr_ms": tot["instr_ms"],
            "cnn_launches": launches[name], "serve_launches": serve["launches"][name],
            "lm_launches": lm["serve"]["launches"][name],
            "train_launches": train["cnn_a"]["launches"][name],
            "fuzz_launches": fuzz_launches[name], "soak_launches": soak_launches[name]})
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": kind, "nvidia_smi": smi, "torch": torch.__version__,
         "kernels": kernels, "layers": rows, "forward": forward, "profiles": profiles,
         "serve": serve, "lm": lm, "train": train, "verify": verify},
        indent=1))
    print("timings: ms, plain_ms, library_ms and bound_ms sum one forward of CNN-A "
          "(batch 64) and one of MobileNetV1-224 (batch 16); launches counts phases 2 "
          "and 3 (three calls of each network), phase 7's serving of gemma-2b, phase "
          "8a's execute of the retrained CNN-A, phase 9a's fuzz and phase 9c's soaks; the "
          "LM shapes' times are under \"lm\" in chiprun_out/chip_smoke.json")
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
