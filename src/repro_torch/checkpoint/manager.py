"""Fault-tolerant checkpointing: npz + manifest, atomic, verified.

Port of ``repro/checkpoint/manager.py`` with the same on-disk format, byte
for byte, so either package restores the other's steps:

  * ``step_<N:010d>/host_<id>.npz`` holds the leaves, keyed by their tree
    path with ``/`` written as ``__`` (``program__instrs__3__B_tap_packed``);
    ``manifest.json`` (``manifest_host_<id>.json`` with ``n_hosts > 1``)
    records each leaf's shape, dtype and CRC32, the caller's ``extra`` and
    a digest of the manifest itself.
  * Writes are atomic and overwrite-safe: temp dir -> fsync -> rename the
    old step aside -> rename the new dir in (the commit point) -> delete
    the displaced copy.  ``__init__`` scrubs the orphans a crash can leave
    (``.tmp_ckpt_*`` temps, ``.displaced_step_*`` set-aside copies).
  * Restore verifies every leaf's CRC32 (``ChecksumMismatch`` names the
    leaf), the manifest's own digest (``ManifestMismatch``), and shape and
    dtype against the manifest and the restore target (``LeafMismatch``; no
    silent cast unless ``allow_cast=True``).  Each leaf is placed on the
    device of the target's tensor.
  * ``restore_latest_good`` walks steps newest-first, quarantines every
    step that fails (renamed to ``quarantine_step_<N>/`` with a JSON reason
    ledger, never deleted) and returns the first that passes.

Trees are nested dicts (keys in sorted order), tuples and lists, and
frozen dataclasses that name their tensor fields in ``TREE_FIELDS`` (the
port's program and instructions); ``None`` holds no leaf.  Paths are the
JAX package's: dict keys, sequence indices and field names joined by
``/``, fields in ``TREE_FIELDS`` order.

Sharded state: a DTensor leaf is saved whole (the JAX format has no
shards), so a save with DTensor leaves is a collective that every rank of
their process group calls; rank 0 writes and the others wait for its
commit.  ``restore(shardings=...)`` places each leaf onto its
``NamedSharding`` (``sharding/placement.py``), which need not be the mesh
it was saved from: reshard-on-restore, each rank keeping its own shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
import zipfile
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import placement as pl

_TMP_PREFIX = ".tmp_ckpt_"
_DISPLACED_PREFIX = ".displaced_"
_QUARANTINE_PREFIX = "quarantine_"


def crc32_hex(data: bytes) -> str:
    """CRC32 of ``data`` as a fixed-width lowercase hex string."""
    return f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def _manifest_digest(meta: dict) -> str:
    doc = {k: v for k, v in meta.items() if k != "manifest_crc32"}
    return crc32_hex(json.dumps(doc, sort_keys=True).encode())


class CheckpointCorruption(RuntimeError):
    """A checkpoint step cannot be trusted (digest, structure, or IO)."""

    def __init__(self, message: str, *, step: int | None = None):
        super().__init__(message)
        self.step = step


class ChecksumMismatch(CheckpointCorruption):
    """A leaf's bytes no longer hash to the digest recorded at save time."""

    def __init__(self, message: str, *, step: int | None, leaf: str,
                 expected: str, actual: str):
        super().__init__(message, step=step)
        self.leaf = leaf
        self.expected = expected
        self.actual = actual


class ManifestMismatch(CheckpointCorruption):
    """The manifest itself no longer hashes to its recorded digest."""

    def __init__(self, message: str, *, step: int | None, expected: str,
                 actual: str):
        super().__init__(message, step=step)
        self.expected = expected
        self.actual = actual


class LeafMismatch(CheckpointCorruption):
    """Loaded leaf shape/dtype disagrees with the manifest or the target."""

    def __init__(self, message: str, *, step: int | None, leaf: str):
        super().__init__(message, step=step)
        self.leaf = leaf


class NoGoodCheckpoint(RuntimeError):
    """``restore_latest_good`` exhausted every step without success."""


# ---------------------------------------------------------------- trees ---

def _children(node):
    """``[(path key, child)]`` of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    fields = getattr(type(node), "TREE_FIELDS", None)
    if fields is not None:
        return [(f, getattr(node, f)) for f in fields]
    return None


def _walk(node, prefix: tuple, out: dict) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out["/".join(prefix)] = node
        return
    for key, child in kids:
        _walk(child, prefix + (str(key),), out)


def _flatten_with_paths(tree):
    """``({path: leaf}, treedef)`` in flattening order.  The treedef is the
    tree itself: :func:`_unflatten` rebuilds its structure around new
    leaves, keeping every non-tensor field of a dataclass node.  (The walks
    recurse at module level: a recursive closure is a reference cycle, which
    would keep the leaves on the device until the cycle collector ran.)"""
    out = {}
    _walk(tree, (), out)
    return out, tree


def _build(node, it):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        return next(it)
    new = [_build(child, it) for _, child in kids]
    if isinstance(node, dict):
        return {k: v for (k, _), v in zip(kids, new)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):   # a NamedTuple
        return type(node)(*new)
    if isinstance(node, (tuple, list)):
        return type(node)(new)
    return dataclasses.replace(node, **{f: v for (f, _), v in zip(kids, new)})


def _unflatten(treedef, leaves):
    """``treedef`` (a tree from :func:`_flatten_with_paths`) with its leaves
    replaced, in flattening order, by ``leaves``."""
    it = iter(leaves)
    rebuilt = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return rebuilt


# numpy has no bfloat16: a bfloat16 leaf is stored as 2-byte voids and
# recorded as "bfloat16", which is what the JAX package's save writes
_BF16_STORED = np.dtype("V2")


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = pl.full(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_STORED)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_STORED else str(arr.dtype)


def _numpy_dtype(target) -> np.dtype:
    if isinstance(target, torch.Tensor):
        if target.dtype == torch.bfloat16:
            return _BF16_STORED
        return torch.empty((), dtype=target.dtype).numpy().dtype
    return np.dtype(target.dtype)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if arr.dtype == _BF16_STORED:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(like.device)
    return torch.from_numpy(arr).to(like.device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1, scrub: bool = True):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        #: (step, reason) for every step this manager quarantined.
        self.quarantined: list[tuple[int, str]] = []
        os.makedirs(directory, exist_ok=True)
        if scrub:
            self._scrub_orphans()

    def _scrub_orphans(self):
        """Clean up after crashed saves (see the commit protocol in save).

        ``.tmp_ckpt_*``: a save died before its commit rename — nothing was
        displaced, so the temp is garbage.  ``.displaced_step_*``: a save
        died *between* renaming the old step aside and committing the new
        one — the displaced dir holds the last intact copy of that step, so
        it is restored unless the commit actually landed.
        """
        for d in sorted(os.listdir(self.dir)):
            path = os.path.join(self.dir, d)
            if d.startswith(_TMP_PREFIX):
                shutil.rmtree(path, ignore_errors=True)
            elif d.startswith(_DISPLACED_PREFIX):
                orig = d[len(_DISPLACED_PREFIX):].rsplit("_", 1)[0]
                dest = os.path.join(self.dir, orig)
                if os.path.exists(os.path.join(dest, "manifest.json")):
                    shutil.rmtree(path, ignore_errors=True)  # commit landed
                else:
                    shutil.rmtree(dest, ignore_errors=True)  # partial commit
                    os.rename(path, dest)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _manifest_name(self) -> str:
        """Single-host steps keep ``manifest.json``; with ``n_hosts > 1``
        each host owns ``manifest_host_<id>.json`` so hosts never write the
        same file."""
        if self.n_hosts <= 1:
            return "manifest.json"
        return f"manifest_host_{self.host_id}.json"

    # ------------------------------------------------------------- save ---
    def save(self, step: int, state, *, extra: dict | None = None):
        """state: a tree of tensors / arrays (copied to the host).  extra:
        JSON-able, stored in the digest-protected manifest.

        Single-host saves commit the whole step dir with the
        rename-aside/rename-in protocol below.  Multi-host saves
        (``n_hosts > 1``) share the step dir: each host stages its
        ``host_<id>.npz`` + ``manifest_host_<id>.json`` in a temp dir and
        merge-commits them with per-file atomic ``os.replace``, so
        concurrent hosts never displace each other's files.

        DTensor leaves are gathered whole, one leaf at a time, on every rank
        (a collective); only rank 0 of the process group copies them to the
        host and writes, and every rank returns after its commit.
        """
        flat, _ = _flatten_with_paths(state)
        if any(pl.is_dtensor(v) for v in flat.values()):
            writer = dist.get_rank() == 0
            hosts = {}
            for k, v in flat.items():
                whole = pl.full(v.detach()) if isinstance(v, torch.Tensor) else v
                if writer:
                    hosts[k] = _to_host(whole)
                del whole
            step_dir = self._step_dir(step)
            try:
                if writer:
                    step_dir = self._save(step, hosts, extra)
            finally:
                dist.barrier()
            return step_dir
        return self._save(step, flat, extra)

    def _save(self, step: int, flat: dict, extra: dict | None) -> str:
        step_dir = self._step_dir(step)
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=_TMP_PREFIX)
        displaced = None
        try:
            arrays = {}
            meta = {"step": step, "host_id": self.host_id,
                    "n_hosts": self.n_hosts, "extra": extra or {},
                    "leaves": {}}
            for key, leaf in flat.items():
                host = _to_host(leaf)
                # ascontiguousarray promotes 0-d to (1,); keep scalar shapes
                arr = np.ascontiguousarray(host).reshape(host.shape)
                arrays[key.replace("/", "__")] = arr
                meta["leaves"][key] = {
                    "shape": list(arr.shape), "dtype": _dtype_name(arr),
                    "crc32": crc32_hex(arr.tobytes())}
            meta["manifest_crc32"] = _manifest_digest(meta)
            np.savez(os.path.join(tmp, f"host_{self.host_id}.npz"), **arrays)
            with open(os.path.join(tmp, self._manifest_name()), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if self.n_hosts > 1:
                os.makedirs(step_dir, exist_ok=True)
                for name in sorted(os.listdir(tmp)):
                    os.replace(os.path.join(tmp, name),
                               os.path.join(step_dir, name))
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                # the old step is renamed aside (intact) before the new dir
                # is committed, so a crash between the two renames loses
                # nothing — __init__ recovers the displaced copy
                if os.path.exists(step_dir):
                    displaced = self._displaced_name(step_dir)
                    os.rename(step_dir, displaced)
                self._commit(tmp, step_dir)  # commit point
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            if displaced is not None and not os.path.exists(step_dir):
                with contextlib.suppress(OSError):
                    os.rename(displaced, step_dir)  # roll the old step back
                displaced = None
            raise
        if displaced is not None:
            shutil.rmtree(displaced, ignore_errors=True)
        if self.host_id == 0:
            self._gc()   # one host gc's; racing deletes corrupt live saves
        return step_dir

    def _displaced_name(self, step_dir: str) -> str:
        base = os.path.basename(step_dir)
        i = 0
        while True:
            cand = os.path.join(self.dir, f"{_DISPLACED_PREFIX}{base}_{i}")
            if not os.path.exists(cand):
                return cand
            i += 1

    def _commit(self, tmp: str, step_dir: str) -> None:
        """The commit rename, isolated so crash tests can fail it."""
        os.rename(tmp, step_dir)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---------------------------------------------------------- restore ---
    def all_steps(self) -> list[int]:
        """Committed steps, ascending.  Quarantined dirs are skipped; a step
        counts as committed when any host's manifest landed."""
        out = []
        for d in os.listdir(self.dir):
            if not d.startswith("step_"):
                continue
            path = os.path.join(self.dir, d)
            if os.path.exists(os.path.join(path, "manifest.json")) or any(
                    n.startswith("manifest_host_") and n.endswith(".json")
                    for n in os.listdir(path)):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_step(self, step: int, *, verify: bool = True):
        """Load manifest + arrays for ``step``, verifying digests/shapes.

        Raises a typed ``CheckpointCorruption`` subclass on the first
        problem found; manifests without ``crc32``/``manifest_crc32``
        fields are tolerated.
        """
        step_dir = self._step_dir(step)
        manifest = os.path.join(step_dir, self._manifest_name())
        if not os.path.exists(manifest) and self.n_hosts > 1:
            # a step saved single-host, restored under a multi-host manager
            manifest = os.path.join(step_dir, "manifest.json")
        if not os.path.exists(manifest):
            raise CheckpointCorruption(
                f"step {step}: {os.path.basename(manifest)} missing under "
                f"{step_dir}", step=step)
        try:
            with open(manifest) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruption(
                f"step {step}: unreadable manifest.json: {e}", step=step) from e
        npz = os.path.join(step_dir, f"host_{self.host_id}.npz")
        if not os.path.exists(npz):
            raise CheckpointCorruption(
                f"step {step}: host_{self.host_id}.npz missing under "
                f"{step_dir}", step=step)
        try:
            with np.load(npz) as z:
                data = {k: z[k] for k in z.files}
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            raise CheckpointCorruption(
                f"step {step}: unreadable host_{self.host_id}.npz: {e}",
                step=step) from e
        if not verify:
            return meta, data
        recorded = meta.get("manifest_crc32")
        if recorded is not None:
            actual = _manifest_digest(meta)
            if actual != recorded:
                raise ManifestMismatch(
                    f"step {step}: manifest digest {actual} != recorded "
                    f"{recorded} (manifest tampered or torn)",
                    step=step, expected=recorded, actual=actual)
        for key, info in meta.get("leaves", {}).items():
            nkey = key.replace("/", "__")
            if nkey not in data:
                raise CheckpointCorruption(
                    f"step {step}: leaf {key!r} recorded in manifest but "
                    f"absent from npz", step=step)
            arr = data[nkey]
            if list(arr.shape) != list(info["shape"]) or \
                    _dtype_name(arr) != info["dtype"]:
                raise LeafMismatch(
                    f"step {step}: leaf {key!r} loaded as "
                    f"{arr.dtype}{tuple(arr.shape)} but manifest records "
                    f"{info['dtype']}{tuple(info['shape'])}",
                    step=step, leaf=key)
            want = info.get("crc32")
            if want is not None:
                got = crc32_hex(np.ascontiguousarray(arr).tobytes())
                if got != want:
                    raise ChecksumMismatch(
                        f"step {step}: leaf {key!r} digest {got} != "
                        f"recorded {want} (bit rot or torn write)",
                        step=step, leaf=key, expected=want, actual=got)
        return meta, data

    def verify_step(self, step: int) -> list[str]:
        """Digest-check one step; [] when clean, else the problems found."""
        try:
            self._read_step(step, verify=True)
        except CheckpointCorruption as e:
            return [str(e)]
        return []

    def cross_host_digests(self, step: int) -> dict:
        """All-gather-style digest exchange over one step's host files.

        Every host's manifest + npz under the shared step dir is re-read
        and re-hashed (the filesystem walk stands in for the collective).
        Returns ``hosts`` (``host_id -> {"problems": [...], "leaves":
        {key: crc32}}``), ``mismatches`` (leaves recorded by more than one
        host whose digests disagree: replicas that diverged) and ``ok``.
        """
        step_dir = self._step_dir(step)
        if not os.path.isdir(step_dir):
            raise CheckpointCorruption(
                f"step {step}: no step dir under {self.dir}", step=step)
        manifests: dict[int, str] = {}
        for name in sorted(os.listdir(step_dir)):
            if name == "manifest.json":
                manifests[0] = os.path.join(step_dir, name)
            elif name.startswith("manifest_host_") and name.endswith(".json"):
                manifests[int(name[len("manifest_host_"):-len(".json")])] = \
                    os.path.join(step_dir, name)
        report: dict = {"step": step, "hosts": {}, "mismatches": [],
                        "ok": bool(manifests)}
        by_leaf: dict[str, dict[int, str]] = {}
        for host, mpath in sorted(manifests.items()):
            problems: list[str] = []
            leaves: dict[str, str] = {}
            try:
                with open(mpath) as f:
                    meta = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                report["hosts"][host] = {
                    "problems": [f"unreadable manifest: {e}"], "leaves": {}}
                report["ok"] = False
                continue
            recorded = meta.get("manifest_crc32")
            if recorded is not None and _manifest_digest(meta) != recorded:
                problems.append(
                    f"manifest digest {_manifest_digest(meta)} != recorded "
                    f"{recorded}")
            npz = os.path.join(step_dir, f"host_{host}.npz")
            data: dict[str, np.ndarray] = {}
            if not os.path.exists(npz):
                problems.append(f"host_{host}.npz missing")
            else:
                try:
                    with np.load(npz) as z:
                        data = {k: z[k] for k in z.files}
                except (OSError, ValueError, zipfile.BadZipFile) as e:
                    problems.append(f"unreadable host_{host}.npz: {e}")
            for key, info in meta.get("leaves", {}).items():
                nkey = key.replace("/", "__")
                if nkey not in data:
                    if data:
                        problems.append(f"leaf {key!r} absent from npz")
                    continue
                got = crc32_hex(np.ascontiguousarray(data[nkey]).tobytes())
                leaves[key] = got
                want = info.get("crc32")
                if want is not None and got != want:
                    problems.append(
                        f"leaf {key!r} digest {got} != recorded {want}")
                by_leaf.setdefault(key, {})[host] = got
            report["hosts"][host] = {"problems": problems, "leaves": leaves}
            if problems:
                report["ok"] = False
        for key, per_host in sorted(by_leaf.items()):
            if len(per_host) > 1 and len(set(per_host.values())) > 1:
                report["mismatches"].append(
                    {"leaf": key, "digests": dict(sorted(per_host.items()))})
                report["ok"] = False
        return report

    def restore(self, step: int, target, *, shardings=None, allow_cast: bool = False,
                verify: bool = True):
        """target: a tree of like-structured tensors (or numpy arrays).
        Returns ``(restored, extra)``: the target's structure with every
        leaf loaded from disk, each tensor on its target tensor's device.
        shardings: an optional tree like ``target`` of ``NamedSharding``
        (None for a leaf left whole): each leaf is placed onto it, a DTensor
        of which every rank keeps its own shard (reshard-on-restore for
        elastic scaling).

        Every leaf is digest-verified against the manifest, and its loaded
        shape/dtype must match the target exactly; a dtype difference raises
        ``LeafMismatch`` unless ``allow_cast=True`` makes the conversion
        explicit.  Shape differences always raise.
        """
        meta, data = self._read_step(step, verify=verify)
        flat_t, treedef = _flatten_with_paths(target)
        flat_s = _flatten_with_paths(shardings)[0] if shardings is not None else {}
        out = []
        for key, tgt in flat_t.items():
            nkey = key.replace("/", "__")
            if nkey not in data:
                raise CheckpointCorruption(
                    f"step {step}: target leaf {key!r} absent from "
                    f"checkpoint", step=step)
            arr = data[nkey]
            want_dtype = _numpy_dtype(tgt)
            if tuple(arr.shape) != tuple(tgt.shape):
                raise LeafMismatch(
                    f"step {step}: leaf {key!r} has shape "
                    f"{tuple(arr.shape)} but target expects "
                    f"{tuple(tgt.shape)}", step=step, leaf=key)
            if arr.dtype != want_dtype:
                if not allow_cast:
                    raise LeafMismatch(
                        f"step {step}: leaf {key!r} stored as {arr.dtype} "
                        f"but target expects {want_dtype} (pass "
                        f"allow_cast=True for an explicit conversion)",
                        step=step, leaf=key)
                arr = arr.astype(want_dtype)
            val = _to_tensor(arr, tgt) if isinstance(tgt, torch.Tensor) else arr
            if flat_s.get(key) is not None:
                val = flat_s[key].place(torch.as_tensor(val))
            out.append(val)
        return _unflatten(treedef, out), meta["extra"]

    # ------------------------------------------------- last-known-good ---
    def quarantine_step(self, step: int, *, reason: str = "") -> str:
        """Rename a bad step aside (never deleted) with a reason ledger."""
        name = f"step_{step:010d}"
        src = os.path.join(self.dir, name)
        i = 0
        while True:
            suffix = f"_{i}" if i else ""
            dst = os.path.join(self.dir, f"{_QUARANTINE_PREFIX}{name}{suffix}")
            if not os.path.exists(dst):
                break
            i += 1
        os.rename(src, dst)
        with open(os.path.join(dst, "quarantine.json"), "w") as f:
            json.dump({"step": step, "reason": reason, "from": name}, f,
                      indent=1)
        self.quarantined.append((step, reason))
        return dst

    def quarantine_dirs(self) -> list[str]:
        return sorted(d for d in os.listdir(self.dir)
                      if d.startswith(_QUARANTINE_PREFIX))

    def restore_latest_good(self, target, *, shardings=None, allow_cast: bool = False,
                            validate=None):
        """Walk steps newest-first to the first one that restores cleanly.

        A step fails the walk when digest/shape/dtype verification raises
        ``CheckpointCorruption``, or when the optional ``validate(restored,
        extra)`` hook raises anything — either way the step is quarantined
        (renamed aside with its reason, never deleted) and the walk
        continues.  Returns ``(step, restored, extra)``; raises
        ``NoGoodCheckpoint`` listing every rejection when no step survives.
        """
        steps = self.all_steps()
        if not steps:
            raise NoGoodCheckpoint(f"no checkpoints under {self.dir}")
        rejected = []
        for step in reversed(steps):
            try:
                restored, extra = self.restore(step, target, shardings=shardings,
                                               allow_cast=allow_cast)
                if validate is not None:
                    validate(restored, extra)
            except CheckpointCorruption as e:
                rejected.append((step, str(e)))
                self.quarantine_step(step, reason=str(e))
                continue
            except Exception as e:  # noqa: BLE001 — validate() rejections
                reason = f"{type(e).__name__}: {e}"
                rejected.append((step, reason))
                self.quarantine_step(step, reason=reason)
                continue
            return step, restored, extra
        detail = "; ".join(f"step {s}: {r}" for s, r in rejected)
        raise NoGoodCheckpoint(
            f"all {len(rejected)} checkpoint step(s) under {self.dir} "
            f"failed verification — {detail}")
