"""PartitionSpecs as DTensor placements, and the local-shard helpers of the
sharded LM.

A spec names, per tensor dim, the mesh axes it is split over; a DTensor
names, per mesh dim, the tensor dim it splits (``Shard(d)``) or none
(``Replicate()``).  :func:`spec_placements` turns one into the other.  A
tensor dim split over two axes (``("pod", "data")``) is ``Shard(d)`` on
both mesh dims, the first named axis the outer one, which is DTensor's
order when the axes are named in mesh order (the only order the rules
use).  A split over a mesh dim of size 1 is no split: it is placed as
``Replicate()``, which holds the same data and which every DTensor view
op takes (a size-1 ``Shard`` blocks the reshapes inside ``einsum``).

The rest are the places where the LM leaves DTensor's own sharding
propagation and works on a rank's local shard:

  * :func:`columns` — a linear's weights as the rank's whole-K column
    shard: the FSDP dim gathered over the data axes, the output dim left
    split on ``"model"``.  The CUDA kernel takes plain tensors, so it runs
    on that shard, and Algorithm 2 sees whole columns
    (``core/binlinear.py``);
  * :func:`write_rows` — the decode step's in-place cache write, done on
    each rank's shard so the cache keeps its storage and placements;
    :func:`write_stacked` writes a layer of a stacked cache back where the
    layer was not a view (its stacked dim split);
  * :func:`batch_local` — attention's operands made whole on every rank
    but their batch rows, and computed on as local tensors: the reshapes
    around its score and value products merge and split the heads and
    head dims, which DTensor (torch 2.11) refuses to do on a split dim;
    :func:`whole_rows` does the same for one DTensor and keeps it one;
  * :func:`to_local_part` and :func:`write_part` — a computation that
    each rank runs on its own part of the work (the Mamba2 scan: its batch
    rows, as :func:`row_placements` keeps them, and its SSM heads), its
    operands moved to the part's placements as local tensors (their
    gradients summed back over the ranks whose parts differ) and a cache
    written back from the part;
  * :func:`rows_times_whole` — a product with a weight whole on every
    rank (an LM head whose vocab the model axis does not divide) on each
    rank's own rows, however they are split (the Mamba2 blocks' residual:
    the sequence on ``"model"``);
  * :func:`sum_over_shards` — a global sum from per-shard sums (the
    optimizer's gradient norm; the update itself is elementwise and runs
    on the local shards).

Several ranks on one card must use gloo (NCCL refuses two ranks on one
device), and gloo's all-gather into one tensor, which DTensor's
``Shard -> Replicate`` issues, crashes the process on a card's tensors
(torch 2.11, ``chip_smoke.py`` phase 14).  Its all-reduce, reduce-scatter,
all-to-all and point-to-point ops take them.  Inside
:func:`gloo_gathers_through_host`, DTensor's all-gathers of card tensors go
through host memory; ``distributed.run_local`` enters it in each rank
that runs on a card over gloo, and leaves it when the rank's body returns.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

MODEL_AXIS = "model"


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def _axis_names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def spec_placements(spec, mesh) -> tuple:
    """A PartitionSpec -> one placement per mesh dim of ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    used = set()
    for dim, axes in enumerate(spec or ()):
        if axes is None:
            continue
        idx = [names.index(a) for a in _axis_names(axes)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        for i in idx:
            if i in used:
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} splits two dims")
            used.add(i)
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    return tuple(out)


def place(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (the same whole tensor on every rank) as a DTensor on ``mesh``:
    each rank keeps its own shard, contiguous and in storage of its own (so
    the whole tensor can be freed); no data moves between ranks."""
    from torch.distributed.tensor import distribute_tensor

    d = distribute_tensor(t, mesh, placements, src_data_rank=None)
    loc = d.to_local()
    if loc.is_contiguous() and loc.untyped_storage().nbytes() == loc.numel() * loc.element_size():
        return d
    return DTensor.from_local(loc.contiguous().clone(), mesh, placements, shape=d.shape,
                              stride=d.stride())


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``'s counterpart: a mesh and one
    placement per mesh dim."""
    mesh: object
    placements: tuple

    def place(self, t: torch.Tensor) -> DTensor:
        return place(t, self.mesh, self.placements)


def local(t):
    """A DTensor's local shard (a view: writes land in the DTensor); a
    plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def full(t):
    """A DTensor gathered whole on every rank; a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def as_dtensor(t, mesh) -> DTensor:
    """A plain tensor (the same on every rank) as a replicated DTensor."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def from_local(t: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A rank's local tensor as the DTensor of global ``shape``."""
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=shape,
                              stride=stride)


def model_dim(mesh) -> int | None:
    """The index of the mesh's ``"model"`` dim (None when it has none)."""
    names = tuple(mesh.mesh_dim_names)
    return names.index(MODEL_AXIS) if MODEL_AXIS in names else None




def model_size(mesh) -> int:
    """The size of the mesh's ``"model"`` axis (1 when it has none)."""
    m = model_dim(mesh)
    return 1 if m is None else mesh.size(m)


def _on_model(mesh, i: int, m: int | None, dim: int, other):
    return Shard(dim) if i == m and mesh.size(i) > 1 else other


def model_local(t: DTensor) -> tuple[torch.Tensor, object]:
    """A DTensor gathered whole on every mesh dim but ``"model"`` (its FSDP
    split undone), as the rank's local tensor, and its placement on
    ``"model"`` (``Replicate()`` on a mesh without one).  Differentiable:
    the gather's backward reduce-scatters the gradient back."""
    mesh = t.device_mesh
    m = model_dim(mesh)
    placements = tuple(p if i == m else Replicate() for i, p in enumerate(t.placements))
    return (t.redistribute(mesh, placements).to_local(),
            placements[m] if m is not None else Replicate())


def column_placements(mesh, ndim: int) -> tuple:
    """The last dim split on ``"model"``, every other mesh dim replicated."""
    m = model_dim(mesh)
    return tuple(_on_model(mesh, i, m, ndim - 1, Replicate()) for i in range(mesh.ndim))


def columns(t: DTensor) -> tuple[torch.Tensor, tuple]:
    """A weight's column shard on this rank, whole along every other dim
    (its FSDP dim gathered over the data axes: an all-gather when the tree
    is FSDP, nothing when it is TP-only), as a contiguous local tensor, and
    its placements (differentiable: the gather's backward reduce-scatters
    the gradient back to ``t``'s placements)."""
    mesh = t.device_mesh
    pl = column_placements(mesh, t.ndim)
    return t.redistribute(mesh, pl).to_local().contiguous(), pl


def row_placements(x: DTensor, *, batch_only: bool = False) -> tuple:
    """Where a linear's input must be for the column-parallel kernel: whole
    along K (replicated on ``"model"``), its rows left split on the mesh
    dims other than ``"model"`` where a leading dim splits them: the batch,
    or the sequence under the sequence-sharded rules.  ``batch_only``
    keeps a split of the batch (dim 0) alone."""
    m = model_dim(x.device_mesh)
    last = 1 if batch_only else x.ndim - 1
    return tuple(p if (i != m and isinstance(p, Shard) and p.dim < last and x.ndim > 1)
                 else Replicate() for i, p in enumerate(x.placements))


def whole_rows(t, *, batch_only: bool = False):
    """A DTensor moved to :func:`row_placements` (its rows split as they
    are, every other dim whole); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, row_placements(t, batch_only=batch_only))


def rows_local(x, mesh) -> tuple[torch.Tensor, tuple]:
    """``x`` moved to :func:`row_placements`: (its local rows, placements);
    a split sequence stays split, so the kernel runs on the rank's
    ``[B, S / d, K]`` rows."""
    x = whole_rows(as_dtensor(x, mesh))
    return x.to_local(), x.placements


def contiguous_local(t):
    """A DTensor whose local shard is contiguous: a dim split unevenly
    comes back from a redistribution as a narrowed view, which a later view
    of the shard cannot take (and DTensor's ``contiguous`` keeps); a plain
    tensor, or a contiguous shard, as it is.  Differentiable."""
    if not isinstance(t, DTensor) or t.to_local().is_contiguous():
        return t
    loc = t.to_local(grad_placements=t.placements).contiguous()
    return DTensor.from_local(loc, t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def batch_local(*ts):
    """Operands of one batched computation (attention's q, k, v and mask)
    as plain local tensors that hold the same batch rows on every rank,
    every other dim whole, and ``back(y)`` that makes a local result the
    global DTensor again.  A mesh dim other than ``"model"`` keeps the rows
    split where an operand has them split (the others are sliced to match,
    a plain operand of the batch's length included); every other split is
    gathered.  With no DTensor among them, the operands as they are and
    ``back`` the identity.  Differentiable.  (Attention on the local rows
    runs none of DTensor's sharding propagation, which is slow on the
    first sight of each batched product, and takes the reshapes around its
    products, which DTensor refuses on a split dim.)"""
    ds = [t for t in ts if isinstance(t, DTensor)]
    if not ds:
        return list(ts), lambda y: y
    mesh, B = ds[0].device_mesh, ds[0].shape[0]
    m = model_dim(mesh)
    rows = tuple(Shard(0) if i != m and any(
        isinstance(t.placements[i], Shard) and t.placements[i].dim == 0
        for t in ds if t.ndim > 1 and t.shape[0] == B) else Replicate()
        for i in range(mesh.ndim))
    whole = (Replicate(),) * mesh.ndim
    out = []
    for t in ts:
        batched = t is not None and t.ndim > 1 and t.shape[0] == B
        if not isinstance(t, DTensor):
            if not (batched and B > 1 and rows != whole):
                out.append(t)
                continue
            t = as_dtensor(t, mesh)
        out.append(t.redistribute(mesh, rows if batched else whole).to_local())
    return out, lambda y: from_local(y, mesh, rows, (B,) + tuple(y.shape[1:]))


def to_local_part(t, mesh, placements, split) -> torch.Tensor:
    """``t`` (a DTensor, or a plain tensor that is the same on every rank)
    moved to ``placements`` and taken as the rank's local tensor, for a
    computation in which the ranks along mesh dim ``i`` work on different
    parts where ``split[i]``.  Differentiable: where ``t`` is whole along
    such a dim, each rank's local gradient is declared a partial sum, so the
    backward sums the ranks' parts into ``t``'s placements (a reduce-scatter
    or an all-reduce); a local tensor taken as it is is a view of ``t``'s
    shard."""
    grad = tuple(Partial() if s and not isinstance(p, Shard) else p
                 for p, s in zip(placements, split))
    return as_dtensor(t, mesh).redistribute(mesh, placements).to_local(grad_placements=grad)


def write_part(dst: DTensor, value: torch.Tensor, placements) -> None:
    """``dst`` set in place to ``value``, the rank's local tensor at
    ``placements`` (the part it computed): moved to ``dst``'s placements
    and copied into the rank's own shard, so ``dst`` keeps its storage and
    placements."""
    mesh = dst.device_mesh
    v = from_local(value, mesh, placements, dst.shape).redistribute(mesh, dst.placements)
    dst.to_local().copy_(v.to_local())


def rows_times_whole(x: DTensor, w: DTensor) -> DTensor:
    """``x @ w`` for a ``w`` whole on every rank and an ``x`` split only
    along its leading dims: each rank multiplies its own rows, with no
    DTensor propagation (slow on a 3-D mesh), and the result keeps ``x``'s
    placements.  Differentiable: ``w``'s local gradient is a partial sum
    over the mesh dims that split ``x``."""
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in x.placements)
    y = x.to_local() @ w.to_local(grad_placements=grad)
    return from_local(y, x.device_mesh, x.placements, tuple(x.shape[:-1]) + (w.shape[-1],))


def columns_out(y: torch.Tensor, mesh, row_pl, shape) -> DTensor:
    """A column-parallel product's local ``y`` as the global DTensor: rows
    placed as its input's, columns split on ``"model"``."""
    m = model_dim(mesh)
    pl = tuple(_on_model(mesh, i, m, len(shape) - 1, p) for i, p in enumerate(row_pl))
    return from_local(y, mesh, pl, shape)


def embedding(tokens, table: DTensor) -> DTensor:
    """``table[tokens]`` over a DTensor table [V, D], vocab-parallel: the
    table's FSDP (D) split gathered, the ids made whole on the mesh dims
    that split the vocab (their rows stay split elsewhere), each rank
    looking up the ids in its vocab rows and zeros for the others, and the
    rows summed over the vocab-splitting mesh dims.  (DTensor's own lookup
    over a vocab-split table fails when the ids' rows are split too, and
    when its masked partial result is read twice.)  Differentiable: the
    table's local gradient is declared partial over the mesh dims that
    split the rows."""
    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    ids = as_dtensor(tokens, mesh)
    id_pl = [Replicate() if v or not (isinstance(p, Shard) and p.dim == 0) else p
             for v, p in zip(vocab, ids.placements)]
    ids = ids.redistribute(mesh, id_pl)
    rows = [Shard(0) if v else Replicate() for v in vocab]
    grad = [Partial() if isinstance(p, Shard) else q for p, q in zip(id_pl, rows)]
    cols = table.redistribute(mesh, rows)
    local = cols.to_local(grad_placements=grad)
    i = ids.to_local() - _local_offset(cols)[0]
    inside = (i >= 0) & (i < local.shape[0])
    y = F.embedding(i.clamp(0, local.shape[0] - 1), local) * inside[..., None].to(local.dtype)
    y = from_local(y, mesh, [Partial() if v else p for v, p in zip(vocab, id_pl)],
                   tuple(ids.shape) + (table.shape[1],))
    return y.redistribute(mesh, id_pl)


def _local_offset(t: DTensor) -> tuple:
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)[1]


def write_rows(cache, slot: torch.Tensor, rows: torch.Tensor) -> None:
    """``cache[b, slot[b]] = rows[b]`` for every batch row ``b``, in place.
    cache ``[B, S, ...]``, slot ``[B]``, rows ``[B, ...]``.  On a DTensor
    cache each rank writes its own shard: the rows and slots are moved to
    the cache's batch and feature placements, and a rank whose sequence
    chunk does not hold a row's slot leaves that row as it was."""
    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), slot] = rows.to(cache.dtype)
        return
    mesh = cache.device_mesh
    row_pl, slot_pl, seq_split = [], [], False
    for p in cache.placements:
        if isinstance(p, Shard) and p.dim == 0:
            row_pl.append(Shard(0))
            slot_pl.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 1:
            row_pl.append(Replicate())
            slot_pl.append(Replicate())
            seq_split = True
        elif isinstance(p, Shard):
            row_pl.append(Shard(p.dim - 1))
            slot_pl.append(Replicate())
        else:
            row_pl.append(Replicate())
            slot_pl.append(Replicate())
    c = cache.to_local()
    r = as_dtensor(rows, mesh).redistribute(mesh, row_pl).to_local().to(c.dtype)
    s = as_dtensor(slot, mesh).redistribute(mesh, slot_pl).to_local()
    b = torch.arange(c.shape[0], device=c.device)
    if not seq_split:
        c[b, s] = r
        return
    s = s - _local_offset(cache)[1]
    inside = (s >= 0) & (s < c.shape[1])
    s = s.clamp(0, c.shape[1] - 1)
    keep = inside.reshape((-1,) + (1,) * (r.ndim - 1))
    c[b, s] = torch.where(keep, r, c[b, s])


def write_stacked(t, i: int, value) -> None:
    """``t[i] = value`` in place, where ``value`` is the ``t[i]`` taken
    earlier and written since, and is not a view of ``t``: a DTensor whose
    stacked ``[L, ...]`` dim is split (the cache rules match the batch dim
    by size, so a layer count equal to the batch takes the batch's split),
    whose ``t[i]`` DTensor makes from a gathered copy.  Each rank holding
    layer ``i`` writes its own shard; anything else (a plain tensor, an
    unsplit stacked dim: ``t[i]`` was a view) is left as it is."""
    if not isinstance(t, DTensor) or not any(isinstance(p, Shard) and p.dim == 0
                                             for p in t.placements):
        return
    mesh = t.device_mesh
    layer_pl = [Replicate() if isinstance(p, Shard) and p.dim == 0
                else Shard(p.dim - 1) if isinstance(p, Shard) else p for p in t.placements]
    v = as_dtensor(value, mesh).redistribute(mesh, layer_pl).to_local()
    loc, off = t.to_local(), _local_offset(t)[0]
    if off <= i < off + loc.shape[0]:
        loc[i - off].copy_(v)


def sum_over_shards(value: torch.Tensor, like) -> torch.Tensor:
    """``value``, a sum over ``like``'s local shard, summed over the ranks
    that hold the other shards of ``like`` (once per shard: replicas are
    not counted twice).  A plain ``like`` gives ``value`` back."""
    if not isinstance(like, DTensor):
        return value
    pl = [Partial() if isinstance(p, Shard) else Replicate() for p in like.placements]
    return DTensor.from_local(value, like.device_mesh, pl, run_check=False).full_tensor()


def _through_host(gather):
    def staged(self, gather_dim, group, tag=""):
        if self.device.type == "cpu":
            return gather(self, gather_dim, group, tag)
        out = gather(self.cpu(), gather_dim, group, tag)
        if isinstance(out, funcol.AsyncCollectiveTensor):
            out = out.wait()
        return out.to(self.device)
    return staged


@contextlib.contextmanager
def gloo_gathers_through_host():
    """Within: DTensor's all-gathers (``funcol.all_gather_tensor`` and, where
    torch has it, ``all_gather_single``) gather host copies of card tensors
    and copy the result back; host tensors pass as they are.  On exit the
    originals are back.  Raises if this torch has no ``all_gather_tensor``,
    since DTensor's gathers would then bypass the staging unseen."""
    if not callable(getattr(funcol, "all_gather_tensor", None)):
        raise RuntimeError("torch.distributed._functional_collectives has no "
                           "all_gather_tensor: DTensor's gathers cannot be staged")
    saved = {name: getattr(funcol, name) for name in ("all_gather_tensor", "all_gather_single")
             if callable(getattr(funcol, name, None))}
    for name, gather in saved.items():
        setattr(funcol, name, _through_host(gather))
    try:
        yield
    finally:
        for name, gather in saved.items():
            setattr(funcol, name, gather)
