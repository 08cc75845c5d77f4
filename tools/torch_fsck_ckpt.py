"""Checkpoint fsck of the PyTorch port: verify every digest in a checkpoint
directory (``tools/fsck_ckpt.py``'s checks over ``repro_torch.checkpoint``;
the port writes the JAX package's format, and this tool imports no jax).

    python tools/torch_fsck_ckpt.py DIR [DIR ...] [--json PATH] [--quiet]

For each directory (a checkpoint dir holding ``step_*`` subdirs, or a
parent whose children are such dirs), re-hash every leaf of every step
against its manifest CRC32, re-hash the manifest against its own recorded
digest, and cross-check recorded shapes/dtypes — exactly the checks
``CheckpointManager.restore`` runs, but read-only: nothing is quarantined,
renamed, or deleted (``scrub=False``), so fsck is safe to point at a live
serving directory.

Prints one verdict line per step (``ok`` or the first problem found),
plus any quarantine dirs already present (informational — they are prior
recoveries' evidence, not new corruption).  Exit codes: 0 all steps clean,
1 any corruption found, 2 usage error (no checkpoint steps found).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(_ROOT / "src"), str(_ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from repro_torch.checkpoint.manager import CheckpointManager


def _is_ckpt_dir(path: str) -> bool:
    try:
        entries = os.listdir(path)
    except OSError:
        return False
    return any(e.startswith("step_") or e.startswith("quarantine_")
               for e in entries)


def _expand(paths: list[str]) -> list[str]:
    """Accept checkpoint dirs directly, or parents of checkpoint dirs."""
    out = []
    for p in paths:
        if _is_ckpt_dir(p):
            out.append(p)
            continue
        try:
            children = sorted(os.listdir(p))
        except OSError:
            continue
        out.extend(c for c in (os.path.join(p, child) for child in children)
                   if os.path.isdir(c) and _is_ckpt_dir(c))
    return out


def fsck(directory: str) -> dict:
    """Verify one checkpoint directory; returns a JSON-able report."""
    mgr = CheckpointManager(directory, scrub=False)
    steps = {}
    bad = 0
    for step in mgr.all_steps():
        problems = mgr.verify_step(step)
        steps[step] = problems
        bad += bool(problems)
    return {
        "directory": directory,
        "steps": steps,
        "corrupt_steps": bad,
        "quarantined": mgr.quarantine_dirs(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+",
                    help="checkpoint dir(s), or parent(s) of checkpoint dirs")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the full report as JSON")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-step verdict lines")
    args = ap.parse_args(argv)

    dirs = _expand(args.dirs)
    reports = [fsck(d) for d in dirs]
    total_steps = sum(len(r["steps"]) for r in reports)
    corrupt = sum(r["corrupt_steps"] for r in reports)

    for r in reports:
        if not args.quiet:
            print(f"{r['directory']}:")
            for step, problems in sorted(r["steps"].items()):
                verdict = "ok" if not problems else problems[0]
                print(f"  step {step}: {verdict}")
            for q in r["quarantined"]:
                print(f"  {q}: quarantined (prior recovery, not re-checked)")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"reports": reports, "total_steps": total_steps,
                       "corrupt_steps": corrupt}, f, indent=1)

    if total_steps == 0:
        print(f"fsck_ckpt: no checkpoint steps found under {args.dirs}",
              file=sys.stderr)
        return 2
    status = "CLEAN" if corrupt == 0 else "CORRUPT"
    print(f"fsck_ckpt: {total_steps} step(s) across {len(reports)} dir(s), "
          f"{corrupt} corrupt — {status}")
    return 0 if corrupt == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
