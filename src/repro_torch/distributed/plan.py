"""MeshPlan: map a compiled BinArrayProgram onto a device mesh.

Port of ``repro/distributed/plan.py``.  The paper scales throughput by
instantiating more Processing Arrays behind one instruction stream (§IV):
the schedule is fixed offline and the arrays replicate compute.  Here the
arrays are the ranks of a ``torch.distributed`` group.  A :class:`MeshPlan`
is the offline decision of how a :class:`~repro_torch.deploy.program.BinArrayProgram`
spreads over an ``(n_data, n_model)`` mesh, frozen before any launch:

  * **data parallelism** (every layer by default): the global batch splits
    over the ``data`` axis and the packed weights are replicated.  It is
    bit-exact because every kernel computes each output row on its own,
    whatever the batch around it.
  * **output-channel (bd) model parallelism** (per layer): a large
    point-wise ``ConvInstr`` splits its D output channels over the
    ``model`` axis.  Each rank runs the conv on its channel slice with a
    device-local frozen :class:`~repro_torch.deploy.program.TilePlan`
    (picked with the compiler's own ``ops.pick_conv_plan``), and an
    ``all_gather`` concatenates the slices.  The slices are computed
    independently, with no reduction across ranks, so the gathered output
    equals the unsharded layer's.

Everything here is static: nothing touches a process group until
:meth:`MeshPlan.build_mesh` or ``distributed.execute_sharded``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.deploy.program import BinArrayProgram, ConvInstr, TilePlan
from repro_torch.kernels import ops

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Point-wise layers below this packed-weight size are not worth splitting:
# the all_gather's latency outweighs the bytes it saves each rank.
DEFAULT_MIN_SHARD_BYTES = 16 * 1024


@dataclasses.dataclass(frozen=True)
class LayerShard:
    """One instruction's placement on the mesh.

    ``kind`` is ``"replicated"`` (weights on every rank, the default) or
    ``"bd"`` (output channels split over the model axis).  For a bd shard,
    ``d_local`` is the per-rank channel count, ``plan`` the device-local
    conv plan (frozen: the sharded forward picks nothing) and
    ``per_device_weight_bytes`` the accounting the verifier re-derives.
    """

    kind: str = "replicated"            # replicated | bd
    d_local: int = 0                    # per-rank output channels (bd)
    plan: TilePlan | None = None        # device-local frozen plan (bd)
    per_device_weight_bytes: int = 0    # packed weight bytes on one rank


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A frozen program -> mesh mapping: axis sizes and one LayerShard per
    instruction.  Hashable, and free of any process group until
    :meth:`build_mesh`."""

    n_data: int
    n_model: int = 1
    shards: tuple[LayerShard, ...] = ()
    global_batch: int = 0               # the batch the plan was picked for
    axis_data: str = DATA_AXIS
    axis_model: str = MODEL_AXIS

    @property
    def devices(self) -> int:
        """Ranks one forward occupies (the paper's Processing Array count)."""
        return self.n_data * self.n_model

    @property
    def local_batch(self) -> int:
        """Per-rank batch after the ragged pad (ceil division)."""
        return -(-max(self.global_batch, 1) // self.n_data)

    def build_mesh(self, device_type: str = "cuda"):
        """The ``(n_data, n_model)`` DeviceMesh over the initialized process
        group, rank ``r`` at ``(r // n_model, r % n_model)``.  Raises when
        the group's world size is not :attr:`devices`."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.devices:
            raise ValueError(
                f"mesh {self.n_data}x{self.n_model} needs a process group of "
                f"{self.devices} ranks, the initialized world has {world}")
        return init_device_mesh(device_type, (self.n_data, self.n_model),
                                mesh_dim_names=(self.axis_data, self.axis_model))

    def describe(self) -> list[str]:
        """One human line per shard (tools/torch_verify_program.py --mesh)."""
        out = [f"mesh {self.n_data}x{self.n_model} "
               f"({self.axis_data},{self.axis_model}), "
               f"global_batch={self.global_batch}"]
        for i, s in enumerate(self.shards):
            if s.kind == "bd":
                out.append(f"  [{i}] bd-sharded: d_local={s.d_local}, "
                           f"plan=(rows={s.plan.rows}, cols={s.plan.cols}), "
                           f"{s.per_device_weight_bytes} B/device")
            else:
                out.append(f"  [{i}] replicated "
                           f"({s.per_device_weight_bytes} B/device)")
        return out


def _shardable(instr, n_model: int, *, pointwise_only: bool) -> bool:
    """Structural preconditions for bd-sharding one instruction: ConvInstr,
    point-wise (unless overridden), D divisible into >= 8-channel byte-even
    slices (the JAX package's rule, kept so the decisions stay the same)."""
    if n_model < 2 or not isinstance(instr, ConvInstr):
        return False
    if pointwise_only and not (instr.kh == 1 and instr.kw == 1):
        return False
    D = int(instr.alpha.shape[-1])
    if D % n_model:
        return False
    d_local = D // n_model
    return d_local >= 8 and d_local % 8 == 0


def plan_mesh(program: BinArrayProgram, *, n_data: int, n_model: int = 1,
              global_batch: int | None = None,
              min_shard_bytes: int = DEFAULT_MIN_SHARD_BYTES,
              pointwise_only: bool = True) -> MeshPlan:
    """Plan a program onto an ``n_data`` x ``n_model`` mesh.

    Every layer is data-parallel with replicated weights by default; a
    ``ConvInstr`` is bd-sharded over the model axis when it is structurally
    shardable (:func:`_shardable`) and its packed weights reach
    ``min_shard_bytes``.  The device-local plan is
    ``ops.pick_conv_plan(b_local * U * V, d_local, pool)`` at the per-rank
    batch, picked without counting as a plan pick.

    The JAX planner also shards a layer whose working set exceeds the VMEM
    budget.  That clause has no counterpart: a picked conv plan always fits
    an H100 block's shared memory (``binary_conv.SHMEM_LIMIT``), whatever
    the layer.  The decisions still match the JAX planner's, because its
    VMEM clause decides no layer of CNN-A or MobileNetV1 at any mesh (with
    ``min_shard_bytes`` set past every layer, it shards none).

    ``global_batch`` defaults to the program's compiled batch; the plan is
    picked for ``ceil(global_batch / n_data)`` images per rank but stays
    correct for any batch.  Reads shapes and static fields only, so it
    works on abstract programs too.
    """
    from repro_torch.analysis.verify import _no_pick_accounting

    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh axes must be >= 1, got "
                         f"n_data={n_data}, n_model={n_model}")
    gb = int(global_batch if global_batch is not None
             else (program.input_shape[0] if program.input_shape else 1))
    if gb < 1:
        raise ValueError(f"global_batch must be >= 1, got {gb}")
    b_local = -(-gb // n_data)
    shards = []
    for instr in program.instrs:
        wb = int(instr.stats.weight_bytes)
        if not (_shardable(instr, n_model, pointwise_only=pointwise_only)
                and wb >= min_shard_bytes):
            shards.append(LayerShard(per_device_weight_bytes=wb))
            continue
        d_local = int(instr.alpha.shape[-1]) // n_model
        _, Uo, Vo, _ = instr.stats.out_shape
        rows = b_local * Uo * Vo * instr.pool * instr.pool
        with _no_pick_accounting():
            plan = TilePlan(*ops.pick_conv_plan(rows, d_local, instr.pool))
        shards.append(LayerShard(kind="bd", d_local=d_local, plan=plan,
                                 per_device_weight_bytes=wb // n_model))
    return MeshPlan(n_data=n_data, n_model=n_model, shards=tuple(shards),
                    global_batch=gb)
