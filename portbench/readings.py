"""Readings for a cell's limits and for its open loop's knee; not part of
the benchmark's own runs.

    python3 portbench/readings.py control --workload <name> --seeds 1,2,3 --seconds 2
    python3 portbench/readings.py sweep --workload <name> --seed 7 --seconds 10 --rates 1000,2000

``control`` runs the cell once per seed in one process, at the cell's own
size and load over a window of ``--seconds``, and prints for each seed the
program's numbers and the control's (the reference with every conv and
matmul operand rounded to TF32, ``reference.py``) on the same answers'
inputs.  A cell's limit lies between the largest program reading and the
smallest control reading (``portbench/limits/<workload>.json``).

``sweep`` runs an open-loop cell at each offered rate (set-up once per
rate) and prints what was due, what was answered inside the window, the
backlog at its close and the latency percentiles; the knee is the highest
rate at which 99 % of due requests were answered inside the window and
the backlog at the close was under one batch.

Each writes its records as JSON under ``--out`` (default ``chiprun_out/``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("control", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, manifest, port
    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 2
    port.load_kernels()
    device = torch.device("cuda", 0)
    cell = manifest.cell(args.workload, ROOT)
    records = []
    if args.what == "control":
        for seed in (int(s) for s in args.seeds.split(",")):
            out = harness.run_cell(cell, seed, args.seconds, False, device,
                                   time.perf_counter(), control=True)
            rec = {"seed": seed, "program": {k: v["value"] for k, v in
                                             out["result"]["check"].items()},
                   "control": out["control"], "compared": out["compared"],
                   "correct": out["result"]["correct"]}
            records.append(rec)
            print(json.dumps(rec), flush=True)
        for name in records[0]["control"]:
            lower = max(r["program"][name] for r in records)
            upper = min(r["control"][name] for r in records)
            print(f"{args.workload} {name}: program max {lower!r} over {len(records)} "
                  f"seeds, control min {upper!r}", flush=True)
    else:
        for rate in (float(r) for r in args.rates.split(",")):
            out = harness.run_cell(cell, args.seed, args.seconds, False, device,
                                   time.perf_counter(), offered_per_s=rate)
            rec = dict(out["sweep"], rate_per_s=rate, correct=out["result"]["correct"])
            records.append(rec)
            print(json.dumps(rec), flush=True)
    path = Path(args.out) / f"{args.what}_{args.workload}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
