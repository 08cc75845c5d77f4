"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared beside its limit); the last lines of standard error repeat
the numbers compared.  Without a CUDA card, with fewer cards than the cell
asks for, without the port beside it, or with a module of JAX or of the
JAX package loaded, it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this script's folder, heads the path: the
# benchmark's modules are imported as ``portbench.*`` and the port from src/
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
CACHE = ROOT / "portbench" / "_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, manifest
    harness.log(f"set-up: torch and the port imported {time.perf_counter() - T_START:.4f} s")

    bench = manifest.load(ROOT)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        harness.log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        harness.log(f"needs {entry['chips']} CUDA card(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from portbench import port
    if not port.ORIGIN.is_relative_to(ROOT / "src"):
        harness.log(f"repro_torch was imported from {port.ORIGIN}, not from this checkout")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    harness.log(f"set-up: card up {time.perf_counter() - T_START:.4f} s")
    port.load_kernels()
    cell = manifest.cell(args.workload, ROOT)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"refused: modules of JAX or the JAX package were loaded: {bad}")
        return 3
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi: {e}"
    result = out["result"]
    harness.log(f"card: {smi}; setup_s {out['setup_s']:.4f}; "
                f"answers compared {out['compared']}")
    for name, v in result["check"].items():
        harness.log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
