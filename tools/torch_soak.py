#!/usr/bin/env python3
"""Soak CLI of the PyTorch/CUDA port: run long-lived-surface scenarios,
assert flat trends.

    python3 tools/torch_soak.py [server executor checkpoint cnn_server ...]
        [--steps N] [--csv-dir DIR] [--ckpt-dir DIR] [--mobilenet-b2]
        [--device cuda|cpu] [--list]

Port of ``tools/soak.py``.  Each scenario
(``repro_torch.testing.scenarios.SCENARIOS``) wraps one long-lived serving
surface — ``Server`` under mixed ``m_active``/prefill traffic,
``deploy.execute`` over rotating §IV-D schedules, the checkpoint
save/load cycle, ``CNNService`` under fault storms — as a step closure
plus gauges (plan picks, loaded kernel libraries, live device bytes on a
card, the surface's own counters).  Each runs through
``repro_torch.testing.soak.run_soak`` and ``SoakResult.assert_flat()``:
RSS, traced heap and latency must fit a flat linear trend after warmup,
and every gauge must end exactly where it started.

``--csv-dir`` writes one ``<scenario>_trend.csv`` per run (step,
rss_bytes, traced_bytes, latency_s + gauge columns).  ``--mobilenet-b2``
swaps the executor scenario's reduced MobileNet for the full B2 at 224²,
1000 classes.  Runs on the card unless ``--device cpu`` is given (then the
kernels' plain versions run), and fails without one.

Exit codes: 0 all flat, 1 any TrendViolation (message names the metric,
slope, and projected growth).
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

# default step counts per scenario, the JAX tool's, so a run of either tool
# covers the same traffic.  One server soak step serves two level-count
# groups, so 1100 steps ~= 2200 decodes (the >= 2000 floor).  cnn_server runs whole
# 54-step fault cycles (clean/storm/clean) so the latency trend sees
# complete cycles, not a half-storm tail.
DEFAULT_STEPS = {"server": 1100, "executor": 260, "checkpoint": 120,
                 "cnn_server": 324}
MOBILENET_B2 = {"width_mult": 1.0, "n_classes": 1000, "resolution": 224}


def main(argv=None) -> int:
    from repro_torch.testing import scenarios as sc
    from repro_torch.testing.soak import TrendViolation, run_soak

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenarios", nargs="*", default=[], metavar="SCENARIO",
                    help=f"which to run (default: all of {sorted(sc.SCENARIOS)})")
    ap.add_argument("--steps", type=int, default=0,
                    help="override step count for every selected scenario")
    ap.add_argument("--csv-dir", default="", metavar="DIR",
                    help="write <scenario>_trend.csv files here")
    ap.add_argument("--ckpt-dir", default="", metavar="DIR",
                    help="checkpoint directory for the cnn_server scenario "
                         "(default: a fresh tempdir)")
    ap.add_argument("--mobilenet-b2", action="store_true",
                    help="executor scenario uses full MobileNet-B2 @224^2")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--list", action="store_true", help="list scenarios and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(sc.SCENARIOS):
            print(name)
        return 0
    names = args.scenarios or sorted(sc.SCENARIOS)
    unknown = [n for n in names if n not in sc.SCENARIOS]
    if unknown:
        ap.error(f"unknown scenario(s) {unknown}; choose from {sorted(sc.SCENARIOS)}")

    csv_dir = pathlib.Path(args.csv_dir) if args.csv_dir else None
    if csv_dir:
        csv_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    for name in names:
        steps = args.steps or DEFAULT_STEPS.get(name, 200)
        print(f"== soak: {name} ({steps} steps) ==", flush=True)
        if name == "executor" and args.mobilenet_b2:
            scen = sc.executor_scenario(mobilenet_kw=MOBILENET_B2, device=args.device)
        elif name == "checkpoint":
            scen = sc.checkpoint_scenario(tempfile.mkdtemp(prefix="soak_ckpt_"),
                                          device=args.device)
        elif name == "cnn_server" and args.ckpt_dir:
            scen = sc.cnn_server_scenario(directory=args.ckpt_dir, device=args.device)
        else:
            scen = sc.SCENARIOS[name](device=args.device)
        result = run_soak(scen.step, steps=steps, name=name, gauges=scen.gauges)
        if csv_dir:
            result.write_csv(str(csv_dir / f"{name}_trend.csv"))
        print(result.summary(), flush=True)
        print(f"   progress: {scen.progress()}", flush=True)
        try:
            result.assert_flat()
            print(f"   {name}: FLAT", flush=True)
        except TrendViolation as e:
            failures.append((name, str(e)))
            print(f"   {name}: VIOLATION — {e}", flush=True)
    if failures:
        print(f"soak: {len(failures)} scenario(s) violated flat-trend tolerances",
              file=sys.stderr)
        return 1
    print("soak: all trends flat")
    return 0


if __name__ == "__main__":
    sys.exit(main())
