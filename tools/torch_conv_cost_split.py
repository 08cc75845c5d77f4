#!/usr/bin/env python3
"""Split the CUDA conv kernel's time into its FFMA loop, its level fold and
its copy issue, at MobileNetV1-224's point-wise shapes (batch 16) and the
plans ``deploy.compile`` picks, on one CUDA card.

    python3 tools/torch_conv_cost_split.py       # from the repository root

Builds four variants of ``src/repro_torch/csrc/binary_conv.cu`` from edited
copies under ``src/repro_torch/csrc/_build/cost_split/``: the kernel as it
is, without the per-chunk fold, without the per-chunk copy issue, and with
neither (the FFMA loop over stale tiles).  Only the first computes the
conv; the others exist to be timed.  Times are CUDA events around 50
back-to-back launches.  Prints one line per shape and writes
``chiprun_out/conv_cost_split.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import binary_conv as bck  # noqa: E402

COPY_ISSUE = "    issue(c + 2);\n"
FOLD = "    if (c + 1 < nch) fold(c + 1, wf_ring + ((c + 1) & 1) * BK * WFP);\n"
VARIANTS = {"kernel": (), "no_fold": (FOLD,), "no_issue": (COPY_ISSUE,),
            "ffma_only": (FOLD, COPY_ISSUE)}
SHAPES = {"pw0": (16, 112, 112, 32, 64), "pw2": (16, 56, 56, 128, 128),
          "pw6": (16, 14, 14, 512, 512), "pw12": (16, 7, 7, 1024, 1024)}


def build(out_dir: Path) -> dict[str, ctypes.CDLL]:
    src = (_build.CSRC / "binary_conv.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cut in VARIANTS.items():
        text = src
        for line in cut:
            if text.count(line) != 1:
                raise SystemExit(f"torch_conv_cost_split: {line.strip()!r} is not in the "
                                 "kernel's chunk loop any more; update VARIANTS")
            text = text.replace(line, "")
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"torch_conv_cost_split: nvcc {name}: {out}")
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.binary_conv_launch.argtypes = bck._ARGTYPES
        lib.binary_conv_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def events_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_cost_split: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    libs = build(_build.BUILD_DIR / "cost_split")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for layer, (B, H, W, C, D) in SHAPES.items():
        x = torch.randn(B, H, W, C, generator=gen).to(dev)
        signs = torch.randint(0, 2, (2, C, D), generator=gen, dtype=torch.int8) * 2 - 1
        tap = bck.pack_taps(signs, 1, 1, C).to(dev)
        alpha = (torch.rand(2, 1, D, generator=gen) * 0.5 + 0.1).to(dev)
        bias = torch.zeros(D, device=dev)
        out = torch.empty(B, H, W, D, device=dev)
        plan = ops.pick_conv_plan(B * H * W, D)
        args = (x.data_ptr(), tap.data_ptr(), alpha.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, H, W, C, D, 2, 1, 1, 1, 0, 0, 1, H, W, 1, C, 2, 1,
                plan[0], plan[1], 0, stream)
        times = {}
        for name, lib in libs.items():
            rc = lib.binary_conv_launch(*args)
            if rc:
                raise SystemExit(f"torch_conv_cost_split: {name} launch failed ({rc})")
            times[name] = events_ms(lambda: lib.binary_conv_launch(*args))
        rows.append({"layer": layer, "shape": [B, H, W, C, D], "plan": list(plan),
                     "ms": times})
        print(f"{layer} [{B}, {H}, {W}, {C}] -> {D} plan {plan}: "
              + ", ".join(f"{k} {v:.5f} ms" for k, v in times.items()))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "conv_cost_split.json").write_text(json.dumps({"card": smi, "rows": rows},
                                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
