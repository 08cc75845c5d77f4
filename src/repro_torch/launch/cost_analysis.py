"""Cost counting of one eager step, and its roofline terms (counterpart of
``repro/launch/hlo_analysis.py``).

The JAX package reads a compiled XLA module: ``cost_analysis()`` for FLOPs
and bytes, the optimized HLO text for the collectives.  The port has no
HLO, so it counts what one eager step dispatches, for one rank:
:class:`CostCounter` is a ``TorchDispatchMode`` that sees every aten op on
the rank's local tensors (DTensor ops are let through to DTensor, whose
local ops and collectives then come back to the counter) and counts

  * FLOPs of the matmul family (``torch.utils.flop_counter``'s formulas),
    split by class: ``"fp32"`` (fp32 and fp64 operands: FFMA, since TF32 is
    off in this repository) and ``"tensor"`` (bf16 and fp16 operands: the
    tensor cores).  Elementwise ops add no FLOPs (XLA counts them: the two
    counts differ by them);
  * bytes accessed: each op's tensor inputs read plus its outputs written.
    Views and aliases count nothing.  The count is of unfused eager ops, so
    it is not comparable with XLA's, which counts a fusion's inputs and
    outputs once;
  * every ``_c10d_functional`` collective: its kind, result bytes and group
    size.  The ops DTensor's sharding propagation runs on global shapes to
    learn an output's shape (once per op signature) are not counted: the
    propagator is silenced while the counter is active.  DTensor's all-to-all (``_collective_utils.shard_dim_alltoall``,
    whose CPU-mesh form is an all-gather and a chunk) is wrapped while the
    counter is active and counts as the one all-to-all it stands for;
  * the peak of the bytes of tensors made during the step and still alive;
  * ``binary_matmul`` calls, which ``kernels/ops.py`` reports (its kernel is
    invisible to the dispatcher, and on ``meta`` it runs nothing), by the
    same MACs and bytes as ``chip_smoke.py``'s per-call bound for the kernel:
    x read and y written in fp32, the packed levels and alphas read once,
    T·K·N fp-equivalent MACs, FFMA.

The hardware model is one NVIDIA H100 SXM5 (data sheet, dense rates):
HBM 3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores, 989.4 TFLOP/s
bf16/fp16 on them, NVLink 4 at 450 GB/s in each direction.  The compute
term sums each class's FLOPs over its own peak (the JAX model has one
peak).  The collective term charges ring wire bytes (the JAX package's
factors) at the NVLink rate: a 16-wide mesh axis spans two 8-GPU nodes, so
that term is a lower bound there.
"""
from __future__ import annotations

import dataclasses
import heapq
import types
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

HBM_BW = 3.35e12            # H100 SXM5 HBM3, bytes/s
PEAK_FLOPS_FP32 = 67e12     # FFMA: the binary kernels and fp32 products
PEAK_FLOPS = 989.4e12       # dense bf16/fp16 tensor-core products
LINK_BW = 450e9             # NVLink 4, one direction, bytes/s

PEAKS = {"fp32": PEAK_FLOPS_FP32, "tensor": PEAK_FLOPS}

_COLLECTIVES = {  # _c10d_functional op name -> the HLO collective it is
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute", "isend": "collective-permute",
}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "_unsafe_view", "lift_fresh", "detach", "alias"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flop_class(dtype: torch.dtype) -> str:
    return "tensor" if dtype in (torch.bfloat16, torch.float16) else "fp32"


def binary_matmul_work(T: int, K: int, N: int, B_packed: torch.Tensor,
                       alpha: torch.Tensor, x_itemsize: int = 4) -> tuple[int, int]:
    """(fp-equivalent MACs, bytes) of one ``binary_matmul`` call: x [T, K]
    read at ``x_itemsize`` bytes an element (4 fp32, 2 bf16) and y [T, N]
    written in fp32, the packed levels and the alphas read once
    (``chip_smoke.py``'s per-call bound)."""
    return (T * K * N, x_itemsize * T * K + B_packed.numel() + 4 * alpha.numel()
            + 4 * T * N)


class CostCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collectives, peak live bytes and
    ``binary_matmul`` calls over the ops dispatched while it is active
    (``with CostCounter() as c: step()``).  It changes no result."""

    TOP = 20

    def __init__(self):
        super().__init__()
        self.flops: dict[str, float] = {}
        self.bytes_accessed = 0
        self.collectives: list[tuple[str, int, int]] = []   # (kind, result bytes, group)
        self.op_counts: dict[str, int] = {}
        self.op_bytes: dict[str, float] = {}
        self.biggest: list[tuple[int, str]] = []             # a min-heap of the TOP largest
        self.binary = {"calls": 0, "macs": 0, "bytes": 0}
        self.live_bytes = self.peak_live_bytes = 0
        self._live: set[int] = set()
        self._quiet = 0
        self._saved: list = []

    # --- what is counted ---------------------------------------------------
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def _add_op(self, name: str, nbytes: int, what: str) -> None:
        self.op_counts[name] = self.op_counts.get(name, 0) + 1
        self.op_bytes[name] = self.op_bytes.get(name, 0.0) + nbytes
        self.bytes_accessed += nbytes
        item = (nbytes, f"{name} {what}"[:100])
        if len(self.biggest) < self.TOP:
            heapq.heappush(self.biggest, item)
        elif item > self.biggest[0]:
            heapq.heapreplace(self.biggest, item)

    def _made(self, t: torch.Tensor) -> None:
        """A tensor made during the step: its storage counts as live until
        freed."""
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        if n == 0 or key in self._live:
            return
        self._live.add(key)
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        if key in self._live:
            self._live.discard(key)
            self.live_bytes -= n

    def binary_matmul(self, T: int, K: int, N: int, B_packed, alpha,
                      x_itemsize: int = 4) -> None:
        """One ``binary_matmul`` call (reported by ``kernels/ops.py``)."""
        macs, nbytes = binary_matmul_work(T, K, N, B_packed, alpha, x_itemsize)
        self.binary["calls"] += 1
        self.binary["macs"] += macs
        self.binary["bytes"] += nbytes
        self.flops["fp32"] = self.flops.get("fp32", 0.0) + 2.0 * macs
        self._add_op("binary_matmul", nbytes, f"[{T}, {K}] x [{K}, {N}]")

    def collective(self, kind: str, nbytes: int, group: int) -> None:
        self.collectives.append((kind, nbytes, group))
        self.op_counts[kind] = self.op_counts.get(kind, 0) + 1

    # --- the dispatch mode ---------------------------------------------------
    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types_):
            return NotImplemented      # DTensor runs it, and its local ops come back here
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                outs = _tensors(out)
                self.collective(kind, sum(_nbytes(t) for t in outs), _group_size(func, args,
                                                                                  kwargs))
                for t in outs:
                    self._made(t)
            return
        outs = _tensors(out)
        if not outs:
            return
        schema = func._schema
        aliased = [r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns]
        if any(aliased) or name in _NO_BYTES:
            if name.startswith(("empty", "new_empty")):
                for t in outs:
                    self._made(t)
            return
        ins = _tensors(args) + _tensors(kwargs)
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            n = f(*args, **kwargs, out_val=out)
            cls = _flop_class(ins[0].dtype)
            self.flops[cls] = self.flops.get(cls, 0.0) + float(n)
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self._add_op(name, nbytes, str([tuple(t.shape) for t in outs])[:60])
        if not schema.is_mutable:
            for t in outs:
                self._made(t)

    # --- DTensor's all-to-all --------------------------------------------------
    def _alltoall(self, real):
        def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
            g = mesh.size(mesh_dim)
            self._quiet += 1
            try:
                if input.device.type == "meta":   # the shape of the exchange, no data
                    whole = torch.cat([input] * g, dim=gather_dim)
                    n = whole.shape[shard_dim]
                    size = -(-n // g)
                    start = min(size * mesh.get_local_rank(mesh_dim), n)
                    out = whole.narrow(shard_dim, start, max(0, min(size, n - start)))
                    out = out.contiguous()
                else:
                    out = real(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._quiet -= 1
            self.collective("all-to-all", _nbytes(out), g)
            self._made(out)
            return out
        return counted

    def _silenced(self, real):
        def silent(*args, **kwargs):
            self._quiet += 1
            try:
                return real(*args, **kwargs)
            finally:
                self._quiet -= 1
        return silent

    def _patch(self, owner, name: str, wrap) -> None:
        """``owner.name`` replaced by ``wrap(owner.name)`` until exit."""
        self._saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrap(getattr(owner, name)))

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor import _collective_utils as cu
        from torch.distributed.tensor import placement_types as pt

        if not callable(getattr(cu, "shard_dim_alltoall", None)):
            raise RuntimeError("torch.distributed.tensor._collective_utils has no "
                               "shard_dim_alltoall: DTensor's all-to-all cannot be counted")
        prop = DTensor._op_dispatcher.sharding_propagator
        names = [n for n in ("propagate_op_sharding", "propagate_op_sharding_non_cached")
                 if callable(getattr(prop, n, None))]
        if not names:
            raise RuntimeError("DTensor's sharding propagator has no propagate_op_sharding: "
                               "the ops it runs to learn shapes would be counted")
        for m in (cu, pt):
            if callable(getattr(m, "shard_dim_alltoall", None)):
                self._patch(m, "shard_dim_alltoall", self._alltoall)
        # sharding propagation runs ops on global shapes to learn its output's
        # (once per op signature): no work of the rank's
        for n in names:
            self._patch(prop, n, self._silenced)
        ops.reporters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ops.reporters.remove(self)
            for owner, name, own in reversed(self._saved):
                if own is None:
                    delattr(owner, name)
                else:
                    setattr(owner, name, own)
            self._saved = []


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a ``_c10d_functional`` op names."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for i, a in enumerate(func._schema.arguments):
        if a.name == "group_name":
            name = kwargs.get("group_name", args[i] if i < len(args) else None)
            return _resolve_process_group(name).size()
    raise RuntimeError(f"{func} names no process group")


# ---------------------------------------------------------------------------
# The JAX module's analysis, over the counted events
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveStats:
    ops: dict            # op kind -> count
    result_bytes: dict   # op kind -> sum of result-shape bytes (per device)
    wire_bytes: float    # ring-effective bytes through each device's links

    def total_result_bytes(self) -> float:
        return float(sum(self.result_bytes.values()))


def collective_stats(events, total_devices: int) -> CollectiveStats:
    """``(kind, result bytes, group size)`` events -> counts, result bytes
    and ring wire bytes (a group size of None is the whole world), by the
    JAX package's ring factors."""
    ops: dict[str, int] = {}
    rbytes: dict[str, float] = {}
    wire = 0.0
    for kind, b, g in events:
        g = max(g or total_devices, 1)
        ops[kind] = ops.get(kind, 0) + 1
        rbytes[kind] = rbytes.get(kind, 0.0) + b
        if kind == "all-gather":
            wire += b * (g - 1) / g
        elif kind == "reduce-scatter":
            wire += b * (g - 1)            # result is the scattered shard
        elif kind == "all-reduce":
            wire += 2 * b * (g - 1) / g
        elif kind == "all-to-all":
            wire += b * (g - 1) / g
        elif kind == "collective-permute":
            wire += b
    return CollectiveStats(ops=ops, result_bytes=rbytes, wire_bytes=wire)


def count_op(counted, opname: str) -> int:
    """Dispatches of aten op ``opname`` (its packet name, e.g. ``"mm"``) or
    of a collective kind in a :class:`CostCounter` or a compiled step."""
    return getattr(counted, "counter", counted).op_counts.get(opname, 0)


def op_bytes_profile(counted, top: int = 20):
    """Bytes accessed per aten op name, largest first, and the largest
    single ops: where the bytes go."""
    c = getattr(counted, "counter", counted)
    return (sorted(c.op_bytes.items(), key=lambda kv: -kv[1])[:top],
            sorted(c.biggest, reverse=True)[:top])


class Compiled:
    """One counted step: ``jax``'s ``Compiled`` surface for the dry run."""

    def __init__(self, counter: CostCounter, argument_bytes: int, output_bytes: int):
        self.counter = counter
        self.argument_bytes, self.output_bytes = argument_bytes, output_bytes

    def cost_analysis(self) -> dict:
        return {"flops": self.counter.total_flops(),
                "bytes accessed": float(self.counter.bytes_accessed)}

    @property
    def flops_by_class(self) -> dict:
        return dict(self.counter.flops)

    @property
    def collectives(self) -> list:
        return list(self.counter.collectives)

    def memory_analysis(self):
        return types.SimpleNamespace(argument_size_in_bytes=self.argument_bytes,
                                     output_size_in_bytes=self.output_bytes,
                                     temp_size_in_bytes=self.counter.peak_live_bytes,
                                     generated_code_size_in_bytes=0)


def local_bytes(tree) -> int:
    """Bytes of the rank's part of every tensor of ``tree`` (a DTensor's
    local shard)."""
    from repro_torch.sharding import placement as pl

    return sum(_nbytes(pl.local(t)) for t in _tensors(tree))


class Lowered:
    """A step and its arguments, ready to be counted (``jit(...).lower``'s
    counterpart): ``compile()`` runs ``fn(*args)`` once under a
    :class:`CostCounter`."""

    def __init__(self, fn, args: tuple, argument_bytes: int):
        self.fn, self.args, self.argument_bytes = fn, args, argument_bytes

    def compile(self) -> Compiled:
        with CostCounter() as counter:
            out = self.fn(*self.args)
        return Compiled(counter, self.argument_bytes, local_bytes(out))


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    collectives: CollectiveStats
    memory_stats: dict
    model_flops: float = 0.0
    model_flops_ratio: float = 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "collective_ops": self.collectives.ops,
            "collective_result_bytes": self.collectives.result_bytes,
            "memory_stats": self.memory_stats,
            "model_flops": self.model_flops,
            "model_flops_ratio": self.model_flops_ratio,
        }


def compute_seconds(flops_by_class: dict) -> float:
    """Each class's FLOPs over its own peak, summed."""
    return sum(f / PEAKS[c] for c, f in flops_by_class.items())


def roofline(compiled: Compiled, *, total_devices: int,
             model_flops: float = 0.0) -> RooflineTerms:
    """Three-term roofline of one rank's counted step."""
    ca = compiled.cost_analysis()
    flops, bytes_accessed = ca["flops"], ca["bytes accessed"]
    coll = collective_stats(compiled.collectives, total_devices)
    compute_s = compute_seconds(compiled.flops_by_class)
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll.wire_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    mem = compiled.memory_analysis()
    memory_stats = {"argument_bytes": mem.argument_size_in_bytes,
                    "output_bytes": mem.output_size_in_bytes,
                    "temp_bytes": mem.temp_size_in_bytes,
                    "generated_code_bytes": mem.generated_code_size_in_bytes}
    return RooflineTerms(
        flops_per_device=flops, bytes_per_device=bytes_accessed,
        wire_bytes_per_device=coll.wire_bytes, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bound=max(terms, key=terms.get), collectives=coll,
        memory_stats=memory_stats, model_flops=model_flops,
        model_flops_ratio=(model_flops / (flops * total_devices)
                           if flops and model_flops else 0.0))
