#!/usr/bin/env python3
"""Statically verify + trace-lint the shipped programs of the PyTorch/CUDA port.

    python3 tools/torch_verify_program.py [--json PATH] [--skip-retrace]
                                          [--device cuda|cpu]

Port of ``tools/verify_program.py`` (without ``--mesh``, which waits for
the port's ``distributed/``).  For each program of the table below (the
JAX benchmark's: CNN-A, MobileNet-B1, MobileNet-B2):

  1. ``repro_torch.analysis.verify_program`` on the abstract compile —
     packed widths, alpha shapes, plan ranges, shared memory, stats drift;
  2. on the card, a concrete compile (seeded random weights, Algorithm 2)
     and ``trace_lint.lint_execute`` at ``m_active`` None and 1 — no
     library conv or product, no plan pick, no float64;
  3. on the card, unless ``--skip-retrace``, ``trace_lint.retrace_findings``
     over 3x repeated mixed-``m_active`` traffic — no new picks or kernel
     libraries, one launch per instruction per call.

``--device cpu`` runs step 1 only: on the CPU ``execute`` runs the plain
versions, which use library ops by design.  Prints every finding and exits
1 if any ERROR surfaced.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))
from repro_torch import deploy, resolve_device  # noqa: E402
from repro_torch.analysis import summarize, trace_lint, verify_program  # noqa: E402
from repro_torch.core.binlinear import QuantConfig  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

# key -> (arch, input shape, abstract_program kwargs), benchmarks/run.py's table
PROGRAMS = {
    "cnn_a": ("cnn_a", (8, 48, 48, 3), {}),
    "mobilenet_b1": ("mobilenet", (8, 128, 128, 3), {"width_mult": 0.5}),
    "mobilenet_b2": ("mobilenet", (8, 224, 224, 3), {}),
}


def concrete(arch: str, shape, kw: dict, quant, dev):
    """The program compiled from seeded random weights."""
    gen = torch.Generator().manual_seed(0)
    if arch == "cnn_a":
        params = cnn.init_cnn_a(gen, device=dev)
    else:
        params = cnn.init_mobilenet(gen, **kw, device=dev)
    return deploy.compile(params, arch, quant, shape, device=dev, golden=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="", metavar="PATH",
                    help="also dump all findings as JSON")
    ap.add_argument("--skip-retrace", action="store_true",
                    help="skip the (executing) retrace check on the card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    quant = QuantConfig(mode="binary", M=2, K_iters=1)
    doc: dict = {"device": str(dev)}
    n_errors = 0
    for key, (arch, shape, kw) in PROGRAMS.items():
        fs = verify_program(deploy.abstract_program(arch, quant, shape, **kw, device=dev))
        if dev.type == "cuda":
            program = concrete(arch, shape, kw, quant, dev)
            fs += verify_program(program)
            for m in (None, 1):
                fs += trace_lint.lint_execute(program, m_active=m,
                                              label=f"execute[{key}, m_active={m}]")
            if not args.skip_retrace:
                x = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(dev)
                fs += trace_lint.retrace_findings(program, x, schedules=(None, 1),
                                                  repeats=3, label=f"retrace[{key}]")
        summ = summarize(fs)
        n_errors += summ["errors"]
        doc[key] = {"summary": summ, "findings": [vars(f) for f in fs]}
        print(f"{key}: {summ['errors']} error(s), {summ['warnings']} warning(s)")
        for f in fs:
            print(f"  {f}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"findings written to {args.json}")
    steps = "static" if dev.type == "cpu" else "static + lint" + (
        "" if args.skip_retrace else " + retrace")
    print(f"torch_verify_program ({steps} on {dev}): {'FAIL' if n_errors else 'OK'} "
          f"({n_errors} ERROR finding(s))")
    return 1 if n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
