#!/usr/bin/env python3
"""Statically verify + trace-lint the shipped programs of the PyTorch/CUDA port.

    python3 tools/torch_verify_program.py [--json PATH] [--skip-retrace]
                                          [--device cuda|cpu]
                                          [--mesh devices=N[,model=K]]

Port of ``tools/verify_program.py``.  For each program of the table below
(the JAX benchmark's: CNN-A, MobileNet-B1, MobileNet-B2):

  1. ``repro_torch.analysis.verify_program`` on the abstract compile —
     packed widths, alpha shapes, plan ranges, shared memory, stats drift;
  2. on the card, a concrete compile (seeded random weights, Algorithm 2)
     and ``trace_lint.lint_execute`` at ``m_active`` None and 1 — no
     library conv or product, no plan pick, no float64;
  3. on the card, unless ``--skip-retrace``, ``trace_lint.retrace_findings``
     over 3x repeated mixed-``m_active`` traffic — no new picks or kernel
     libraries, one launch per instruction per call;
  4. with ``--mesh devices=N[,model=K]``: ``distributed.plan_mesh`` onto
     the N-rank mesh (K-way model parallelism, data parallelism fills the
     rest) and ``analysis.verify_mesh_plan`` over the result: shard
     structure, channel divisibility, each device-local plan against the
     conv kernel, byte accounting.  Static only: no process group is
     touched, so an 8-rank plan audits on one CPU.

``--device cpu`` runs steps 1 and 4 only: on the CPU ``execute`` runs the plain
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
from repro_torch import distributed  # noqa: E402
from repro_torch.analysis import (summarize, trace_lint, verify_mesh_plan,  # noqa: E402
                                  verify_program)
from repro_torch.core.binlinear import QuantConfig  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

# key -> (arch, input shape, abstract_program kwargs), benchmarks/run.py's table
PROGRAMS = {
    "cnn_a": ("cnn_a", (8, 48, 48, 3), {}),
    "mobilenet_b1": ("mobilenet", (8, 128, 128, 3), {"width_mult": 0.5}),
    "mobilenet_b2": ("mobilenet", (8, 224, 224, 3), {}),
}


def parse_mesh(spec: str) -> tuple[int, int]:
    """``devices=N[,model=K]`` -> (n_data, n_model); K must divide N."""
    fields = dict(part.split("=", 1) for part in spec.split(",") if part)
    unknown = set(fields) - {"devices", "model"}
    if unknown or "devices" not in fields:
        raise SystemExit(f"--mesh expects devices=N[,model=K], got {spec!r}")
    devices = int(fields["devices"])
    n_model = int(fields.get("model", 1))
    if devices < 1 or n_model < 1 or devices % n_model:
        raise SystemExit(f"--mesh: model={n_model} must divide devices={devices}")
    return devices // n_model, n_model


def mesh_audit(key: str, program, mesh: tuple[int, int]) -> tuple[dict, int]:
    """Plan ``program`` onto the mesh and verify the plan; returns the
    JSON section and its ERROR count."""
    n_data, n_model = mesh
    plan = distributed.plan_mesh(program, n_data=n_data, n_model=n_model)
    fs = verify_mesh_plan(program, plan)
    summ = summarize(fs)
    print(f"{key} @ mesh {n_data}x{n_model}: {summ['errors']} error(s), "
          f"{summ['warnings']} warning(s), "
          f"{sum(1 for s in plan.shards if s.kind == 'bd')} bd-sharded layer(s)")
    for f in fs:
        print(f"  {f}")
    return ({"n_data": n_data, "n_model": n_model, "summary": summ,
             "findings": [vars(f) for f in fs],
             "totals": distributed.mesh_totals(program, plan)}, summ["errors"])


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
    ap.add_argument("--mesh", default="", metavar="devices=N[,model=K]",
                    help="also plan each program onto this mesh and audit the "
                         "MeshPlan (verify_mesh_plan)")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh) if args.mesh else None
    dev = resolve_device(args.device)

    quant = QuantConfig(mode="binary", M=2, K_iters=1)
    doc: dict = {"device": str(dev)}
    n_errors = 0
    for key, (arch, shape, kw) in PROGRAMS.items():
        abstract = deploy.abstract_program(arch, quant, shape, **kw, device=dev)
        fs = verify_program(abstract)
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
        if mesh is not None:
            doc[key]["mesh"], errors = mesh_audit(key, abstract, mesh)
            n_errors += errors

    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"findings written to {args.json}")
    steps = "static" if dev.type == "cpu" else "static + lint" + (
        "" if args.skip_retrace else " + retrace")
    if mesh is not None:
        steps += f" + mesh {mesh[0]}x{mesh[1]}"
    print(f"torch_verify_program ({steps} on {dev}): {'FAIL' if n_errors else 'OK'} "
          f"({n_errors} ERROR finding(s))")
    return 1 if n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
