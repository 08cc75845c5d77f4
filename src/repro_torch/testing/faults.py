"""Deterministic fault injection for the serving and deployment surfaces.

Port of ``repro/testing/faults.py``.  The CNN service's contract — every
fault is retried, shed or degraded, never a silent wrong answer, never a
stuck queue — is testable only if faults come on demand, at seeded rates,
with exact bookkeeping of what was injected:

  * :class:`FaultPlan` — per-call probabilities for each fault class
    (latency spike, raised exception, NaN/Inf output) and the
    checkpoint-read truncation rate, all drawn from one seeded
    ``numpy.random.Generator`` in the JAX package's order, so one seed
    gives the same ledger in both packages;
  * :class:`FaultInjector` — wraps the executor (``wrap_execute``) and
    ``CheckpointManager.restore`` (``wrap_restore``), counts every injected
    fault in ``counts``, and makes one-shot integrity faults (a bit flipped
    on disk or in memory, a tampered manifest, a missing npz);
  * :func:`inject_faults` — patches ``repro_torch.deploy.executor.execute``
    and ``CheckpointManager.restore`` for the scope of a ``with`` block;
  * :class:`ManualClock` — virtual time for deterministic SLO tests.

The injector never changes a tensor the caller holds: a poisoned output is
a clone, a flipped program is a copy, and truncation shears a leading axis
off one restored leaf — the damage a torn read does, which
``deploy.load_program``'s verification must catch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import time

import numpy as np

from repro_torch.checkpoint.manager import _flatten_with_paths, _unflatten


class InjectedFault(RuntimeError):
    """A deterministic, injected executor failure (transient by contract:
    the next attempt re-draws, so bounded retry is the correct response)."""


@dataclasses.dataclass
class FaultPlan:
    """Per-call fault probabilities, independent draws from the injector's
    seeded stream; a plan with every rate 0 is a no-op wrap."""

    latency_rate: float = 0.0   # sleep latency_s before executing
    latency_s: float = 0.02
    error_rate: float = 0.0     # raise InjectedFault instead of executing
    nan_rate: float = 0.0       # poison one output element with NaN
    inf_rate: float = 0.0       # poison one output element with +Inf
    truncate_rate: float = 0.0  # shear a leading axis off one restored leaf
    seed: int = 0


class FaultInjector:
    """Wrap executor/checkpoint callables with seeded fault draws.

    ``counts``: ``calls``/``restores`` are attempts seen; the other keys
    count faults actually injected.  ``plan`` is read per call, so a soak
    can switch phases by assigning a new :class:`FaultPlan` — the random
    stream carries across phases.
    """

    def __init__(self, plan: FaultPlan, *, sleep=time.sleep):
        self.plan = plan
        self.sleep = sleep
        self.rng = np.random.default_rng(plan.seed)
        self.counts = {"calls": 0, "latency": 0, "error": 0, "nan": 0,
                       "inf": 0, "restores": 0, "truncate": 0,
                       "bitflip_disk": 0, "bitflip_mem": 0,
                       "manifest_tamper": 0, "missing_npz": 0}

    # ---------------------------------------------------------- executor ---
    def wrap_execute(self, fn):
        """``fn(program, x, m_active=None, **kw)`` -> same signature, with
        per-call fault draws.  Draw order is fixed (latency, error, nan,
        inf) so counts replay for a given seed regardless of outcomes."""

        def wrapped(program, x, m_active=None, **kw):
            plan = self.plan
            self.counts["calls"] += 1
            u = self.rng.random(4)
            if u[0] < plan.latency_rate:
                self.counts["latency"] += 1
                self.sleep(plan.latency_s)
            if u[1] < plan.error_rate:
                self.counts["error"] += 1
                raise InjectedFault(
                    f"injected executor fault (call {self.counts['calls']})")
            out = fn(program, x, m_active, **kw)
            if u[2] < plan.nan_rate:
                self.counts["nan"] += 1
                out = out.clone()
                out[(0,) * out.dim()] = float("nan")
            elif u[3] < plan.inf_rate:
                self.counts["inf"] += 1
                out = out.clone()
                out[(0,) * out.dim()] = float("inf")
            return out

        # deploy.selftest unwraps this marker so the golden self-test always
        # measures the clean execute path, even under a live patch
        wrapped._clean_execute = fn
        return wrapped

    # -------------------------------------------------------- checkpoint ---
    def wrap_restore(self, fn):
        """Wrap ``CheckpointManager.restore`` (bound or unbound): with
        probability ``truncate_rate`` the restored tree comes back with one
        leaf's leading axis sheared off — a torn read.  ``extra`` passes
        through untouched."""

        def wrapped(*args, **kw):
            self.counts["restores"] += 1
            restored, extra = fn(*args, **kw)
            if self.rng.random() < self.plan.truncate_rate:
                flat, treedef = _flatten_with_paths(restored)
                leaves = list(flat.values())
                idx = next((i for i, leaf in enumerate(leaves)
                            if getattr(leaf, "ndim", 0) >= 1
                            and leaf.shape[0] > 1), None)
                if idx is not None:
                    self.counts["truncate"] += 1
                    leaves[idx] = leaves[idx][:-1]
                    restored = _unflatten(treedef, leaves)
            return restored, extra

        return wrapped

    # ------------------------------------------ one-shot integrity faults ---
    # Deliberate, ledgered damage to checkpoint and program state; tests
    # reconcile the recovery counters against these ledger entries exactly.

    def flip_bit_on_disk(self, step_dir: str, *, leaf: str | None = None,
                         prefer: str = "packed") -> str:
        """Flip one seeded bit inside one leaf of a saved ``host_*.npz``
        (a packed weight leaf when ``prefer="packed"`` and one exists).
        Restore must then raise ``ChecksumMismatch`` naming the leaf.
        Returns the npz key flipped; the same seed picks the same leaf and
        bit as the JAX package's injector."""
        path = sorted(glob.glob(os.path.join(step_dir, "host_*.npz")))[0]
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        keys = sorted(data)
        if leaf is None:
            packed = [k for k in keys if "B_tap_packed" in k or "B_packed" in k]
            pool = packed if (prefer == "packed" and packed) else keys
            leaf = pool[int(self.rng.integers(len(pool)))]
        arr = np.ascontiguousarray(data[leaf]).copy()
        flat = arr.view(np.uint8).reshape(-1)
        flat[int(self.rng.integers(flat.size))] ^= np.uint8(
            1 << int(self.rng.integers(8)))
        data[leaf] = arr
        np.savez(path, **data)
        self.counts["bitflip_disk"] += 1
        return leaf

    def flip_bit_in_program(self, program, *, instr: int = 0):
        """A copy of ``program`` with one bit flipped in the packed weights
        of instruction ``instr``, on the program's device — corruption every
        static check passes and only the golden self-test catches.

        The flip lands in level 0 (every §IV-D rung applies it, so every
        rung's digest changes), bit 0 of a byte whose packed-axis index is
        0: packing is LSB-first, so that bit is always a real channel or
        input, never byte padding.
        """
        ins = program.instrs[instr]
        field = "B_tap_packed" if hasattr(ins, "B_tap_packed") else "B_packed"
        arr = getattr(ins, field).clone()
        # conv [M, T, C8, D] / linear [M, K8, N] carry the packed axis second
        # to last: pin it to byte 0 and draw the trailing lane; depth-wise
        # [M, T, C8] packs along the trailing axis: pin it, draw the tap
        if ins.kind == "dwconv":
            pos = (0, int(self.rng.integers(arr.shape[1])), 0)
        else:
            lane = int(self.rng.integers(arr.shape[-1]))
            pos = (0,) * (arr.dim() - 2) + (0, lane)
        arr[pos] ^= 1
        flipped = dataclasses.replace(ins, **{field: arr})
        instrs = program.instrs[:instr] + (flipped,) + program.instrs[instr + 1:]
        self.counts["bitflip_mem"] += 1
        return dataclasses.replace(program, instrs=instrs)

    def tamper_manifest(self, step_dir: str, *, key: str = "step") -> None:
        """Rewrite one manifest field without updating the manifest digest —
        the class ``ManifestMismatch`` must catch."""
        path = os.path.join(step_dir, "manifest.json")
        with open(path) as f:
            meta = json.load(f)
        meta[key] = (meta.get(key, 0) + 1 if isinstance(meta.get(key), int)
                     else "tampered")
        with open(path, "w") as f:
            json.dump(meta, f)
        self.counts["manifest_tamper"] += 1

    def remove_npz(self, step_dir: str) -> str:
        """Delete the step's array payload, leaving the manifest — a partial
        directory restore must reject.  Returns the removed path."""
        path = sorted(glob.glob(os.path.join(step_dir, "host_*.npz")))[0]
        os.remove(path)
        self.counts["missing_npz"] += 1
        return path


@contextlib.contextmanager
def inject_faults(plan: FaultPlan, *, sleep=time.sleep):
    """Patch ``repro_torch.deploy.executor.execute`` (which the CNN
    service's default path resolves at call time) and
    ``CheckpointManager.restore`` for the scope of the block; yields the
    :class:`FaultInjector`.  ``repro_torch.deploy.execute``, bound at import,
    stays the clean function, so reference outputs stay computable inside
    the block."""
    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.deploy import executor

    inj = FaultInjector(plan, sleep=sleep)
    real_execute = executor.execute
    real_restore = ckpt_manager.CheckpointManager.restore
    executor.execute = inj.wrap_execute(real_execute)
    ckpt_manager.CheckpointManager.restore = inj.wrap_restore(real_restore)
    try:
        yield inj
    finally:
        executor.execute = real_execute
        ckpt_manager.CheckpointManager.restore = real_restore


class ManualClock:
    """Deterministic time source: ``clock()`` semantics of
    ``time.monotonic`` with explicit advancement; ``sleep`` advances instead
    of blocking, so retry backoff and latency spikes become exact."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += float(dt)

    def sleep(self, dt: float) -> None:
        self.advance(dt)
