#!/usr/bin/env python3
"""Time every tile plan of the three CUDA kernels at each of their
instruction shapes in CNN-A (batch 64) and MobileNetV1-224 (batch 16),
on one CUDA card, and check that all plans give bit-identical outputs.

    python3 tools/torch_plan_sweep.py       # from the repository root

Times are device times of the kernel's wrapper alone (``chip_smoke.graph_ms``:
CUDA events around a CUDA graph of 20 calls, warm L2).  Prints one line per
instruction with every plan's time, the fastest plan and the plan
``deploy.compile`` picked; writes ``chiprun_out/plan_sweep.json``.  The pick
rules in ``repro_torch/kernels/ops.py`` are set from its output.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts the port's src/ on the path)
from repro_torch import deploy  # noqa: E402
from repro_torch.core.binlinear import QuantConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

PLANS = {
    "conv": list(itertools.product((64, 96, 128), (32, 64, 128))),
    "dwconv": list(itertools.product((1, 2, 4, 8), (32, 64, 128, 256))),
    "linear": list(itertools.product((1, 2, 4, 8), (32, 64))),
}


def call(instr, x: torch.Tensor, plan):
    if instr.kind == "conv":
        return lambda: ops.binary_conv2d(x, instr.B_tap_packed, instr.alpha, instr.bias,
                                         kh=instr.kh, kw=instr.kw, stride=instr.stride,
                                         padding=instr.padding, pool=instr.pool,
                                         relu=instr.relu, plan=plan)
    if instr.kind == "linear":
        return lambda: ops.binary_matmul(x, instr.B_packed, instr.alpha, K=instr.K,
                                         group_size=instr.group_size, plan=plan)
    return lambda: ops.binary_dwconv2d(x, instr.B_tap_packed, instr.alpha, instr.bias,
                                       kh=instr.kh, kw=instr.kw, stride=instr.stride,
                                       relu=instr.relu, plan=plan)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_plan_sweep: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    quant = QuantConfig(mode="binary", M=2)
    programs = {
        "cnn_a": deploy.compile(cnn.init_cnn_a(gen, device=dev), "cnn_a", quant,
                                (64, 48, 48, 3), device=dev),
        "mobilenet": deploy.compile(
            cnn.init_mobilenet(gen, width_mult=1.0, n_classes=1000, device=dev),
            "mobilenet", quant, (16, 224, 224, 3), device=dev),
    }
    rows = []
    for arch, program in programs.items():
        batch = program.input_shape[0]
        for instr in program.instrs:
            if instr.kind not in PLANS:
                continue
            x = cs.layer_input(instr, batch, gen, dev)
            want = call(instr, x, tuple(instr.plan))()
            times = {}
            for plan in PLANS[instr.kind]:
                if not torch.equal(call(instr, x, plan)(), want):
                    raise SystemExit(f"torch_plan_sweep: {arch}/{instr.name}: plan {plan} "
                                     f"differs from {tuple(instr.plan)}")
                times[plan] = cs.graph_ms(call(instr, x, plan))
            best = min(times, key=times.get)
            picked = tuple(instr.plan)
            rows.append({"net": arch, "layer": instr.name, "kind": instr.kind,
                         "in_shape": [batch] + list(instr.stats.in_shape[1:]),
                         "picked": list(picked), "picked_ms": times[picked],
                         "best": list(best), "best_ms": times[best],
                         "ms": {f"{p[0]}x{p[1]}": t for p, t in times.items()}})
            print(f"{arch} {instr.name} in {rows[-1]['in_shape']}: picked {picked} "
                  f"{times[picked]:.5f} ms, best {best} {times[best]:.5f} ms; "
                  + " ".join(f"{p[0]}x{p[1]}:{t:.4f}" for p, t in times.items()))
    for kind in PLANS:
        picked = sum(r["picked_ms"] for r in rows if r["kind"] == kind)
        best = sum(r["best_ms"] for r in rows if r["kind"] == kind)
        print(f"sum {kind}: picked {picked:.5f} ms, best per layer {best:.5f} ms")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "plan_sweep.json").write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
