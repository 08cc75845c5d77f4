"""run_local(): a small mesh of ranks on this host.

The counterpart of ``repro/launch/mesh.py make_host_mesh`` (a tiny mesh over
the local devices): ``world`` processes spawned with
``torch.multiprocessing``, each joined to one ``torch.distributed`` group
through a ``file://`` store in a fresh temporary directory (no TCP port to
collide with a neighbour), each running ``fn(rank, world, *args)``.  The
ranks share one card by default (``device="cuda"`` with ``backend="gloo"``:
NCCL refuses two ranks on one device), and ``run_local`` raises before it
spawns when there is no card; ``device="cpu"`` runs them on the CPU.  Each
rank takes an equal share of the host's cores as its intra-op threads.
Ranks on a card over gloo run ``fn`` inside
``sharding.placement.gloo_gathers_through_host``.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device
from repro_torch.sharding import placement as pl


def _rank_main(rank: int, world: int, init: str, backend: str, device: str,
               timeout_s: float, fn, args, results) -> None:
    try:
        # the ranks share this host's cores: oversubscribed intra-op threads
        # spin against each other (20x slower on the CPU at world 2)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        # gloo's all-gather into one tensor crashes on card tensors (torch
        # 2.11): ranks sharing a card stage DTensor's gathers through host
        staged = (pl.gloo_gathers_through_host() if backend == "gloo" and dev.type == "cuda"
                  else contextlib.nullcontext())
        try:
            with staged:
                out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_local(world: int, fn, *args, backend: str = "gloo", device: str = "cuda",
              timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    process group; returns each rank's result, by rank.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and so is
    each result: return numbers and numpy arrays, not tensors (a tensor
    would go by shared memory, which its rank frees when it exits).  A rank that
    raises, dies or outlasts ``timeout_s`` makes this raise with its
    traceback; the other ranks, which may be waiting in a collective, are
    then terminated.  ``device`` is every rank's device, the card unless
    ``"cpu"`` is given (``resolve_device``: raises without a card).
    """
    device = str(resolve_device(device))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out, errors = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init, backend, device, timeout_s, fn, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world and not errors:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        errors[dead[0]] = f"exited with code {procs[dead[0]].exitcode}"
                    elif time.monotonic() > deadline:
                        errors[-1] = f"no result within {timeout_s} s"
                    continue
                (out if ok else errors)[rank] = value
        finally:
            for p in procs:
                p.join(timeout=0 if errors else 30)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    if errors:
        rank, msg = next(iter(errors.items()))
        raise RuntimeError(f"run_local: rank {rank} of {world} failed:\n{msg}")
    return [out[r] for r in range(world)]
