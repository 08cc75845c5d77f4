"""BinArrayProgram: the compiled deployment form of a binary CNN (paper §IV).

Port of ``repro/deploy/program.py``.  An offline compiler turns each layer
into one macro-instruction that carries its packed weights, its epilogue and
a frozen Hopper tile plan; the executor is a loop over the stream.

    ============  ===================================  =====================
    instruction   paper §IV macro-instruction          CUDA kernel it drives
    ============  ===================================  =====================
    ConvInstr     CONV (patch walk + levels + AMU)     csrc/binary_conv.cu
    DWConvInstr   CONV, channel-wise (§V-A3)           csrc/binary_dwconv.cu
    LinearInstr   FC                                   csrc/binary_matmul.cu
    ============  ===================================  =====================

The tensor fields of each instruction and the program's instruction
stream are named in ``TREE_FIELDS``: ``checkpoint/manager.py`` flattens a
program through them to the JAX package's leaf paths
(``program/instrs/3/B_tap_packed``), in the JAX registration order, and
rebuilds it around restored tensors with every other field kept.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class TilePlan(NamedTuple):
    """A frozen kernel schedule.  conv: ``rows`` unpooled outputs (whole
    pool windows) x ``cols`` output channels per thread block; depth-wise: ``rows`` outputs per
    thread (a 1x1, 1x2, 2x2 or 2x4 tile) x ``cols`` channels per block;
    matmul: ``rows`` output rows per thread x ``cols`` output columns per
    block.  Every plan gives bit-identical outputs."""

    rows: int
    cols: int


@dataclasses.dataclass(frozen=True)
class LayerStats:
    """Static per-layer facts the compiler derives once."""

    in_shape: tuple[int, ...]       # activation entering the layer (post-pre)
    out_shape: tuple[int, ...]      # activation leaving it (post-pool/relu)
    padded_in: tuple[int, ...] = () # (Hp, Wp) after SAME resolution, convs
    macs: int = 0                   # fp-equivalent multiply-accumulates
    weight_bytes: int = 0           # packed weights + alpha, bytes


# eq=False: the tensor fields make field-wise equality ill-defined.
@dataclasses.dataclass(frozen=True, eq=False)
class ConvInstr:
    """Fused conv + bias + max-pool + ReLU (paper Eq. 8 + 13)."""

    B_tap_packed: torch.Tensor   # [M, kh*kw, ceil(C/8), D] uint8
    alpha: torch.Tensor          # [M, G, D] float32
    bias: torch.Tensor           # [D] float32 (zeros when the layer has none)
    name: str = ""
    kh: int = 1
    kw: int = 1
    stride: int = 1
    padding: str = "VALID"
    pool: int = 1
    relu: bool = True
    pre: str = "none"
    M: int = 1
    group_size: int = 1
    plan: TilePlan = TilePlan(64, 64)
    stats: LayerStats = LayerStats((), ())

    kind = "conv"
    TREE_FIELDS = ("B_tap_packed", "alpha", "bias")


@dataclasses.dataclass(frozen=True, eq=False)
class DWConvInstr:
    """Fused channel-wise depth-wise conv + bias + ReLU (paper §V-A3)."""

    B_tap_packed: torch.Tensor   # [M, kh*kw, ceil(C/8)] uint8
    alpha: torch.Tensor          # [M, C] float32
    bias: torch.Tensor           # [C] float32
    name: str = ""
    kh: int = 3
    kw: int = 3
    stride: int = 1
    relu: bool = True
    pre: str = "none"
    M: int = 1
    plan: TilePlan = TilePlan(64, 32)
    stats: LayerStats = LayerStats((), ())

    kind = "dwconv"
    TREE_FIELDS = ("B_tap_packed", "alpha", "bias")


@dataclasses.dataclass(frozen=True, eq=False)
class LinearInstr:
    """Binary matmul + bias (+ ReLU), the paper's FC macro-instruction."""

    B_packed: torch.Tensor       # [M, ceil(K/8), N] uint8
    alpha: torch.Tensor          # [M, G, N] float32
    bias: torch.Tensor           # [N] float32
    name: str = ""
    K: int = 1                   # logical reduction dim (pre-padding)
    relu: bool = False
    pre: str = "none"
    M: int = 1
    group_size: int = 1
    plan: TilePlan = TilePlan(16, 64)
    stats: LayerStats = LayerStats((), ())

    kind = "linear"
    TREE_FIELDS = ("B_packed", "alpha", "bias")


Instr = ConvInstr | DWConvInstr | LinearInstr


@dataclasses.dataclass(frozen=True)
class GoldenRecord:
    """Compile-time self-test reference: a seeded probe + output digests.

    ``deploy.compile`` runs a canonical probe (batch 1, ``torch.randn``
    from a seeded CPU generator, see ``deploy/selftest.py``) through every
    §IV-D rung once and records the CRC32 of each output; ``self_test``
    replays it.  The CUDA kernels and the plain versions reduce in their own
    orders, so a digest holds only on the device type it was made on,
    ``device`` ("cuda" or "cpu").  The JSON schema is the JAX package's
    plus that field.
    """

    seed: int
    input_shape: tuple[int, ...]                       # probe shape, batch 1
    digests: tuple[tuple[tuple[int, ...], str], ...]   # (schedule, crc32 hex)
    device: str                                        # device type of the digests

    def schedules(self) -> tuple[tuple[int, ...], ...]:
        return tuple(s for s, _ in self.digests)

    def digest_for(self, schedule: tuple[int, ...]) -> str | None:
        for s, d in self.digests:
            if s == tuple(schedule):
                return d
        return None

    def to_json(self) -> dict:
        return {"seed": self.seed, "input_shape": list(self.input_shape),
                "digests": [[list(s), d] for s, d in self.digests],
                "device": self.device}

    @classmethod
    def from_json(cls, doc: dict) -> "GoldenRecord":
        return cls(seed=int(doc["seed"]),
                   input_shape=tuple(int(v) for v in doc["input_shape"]),
                   digests=tuple((tuple(int(m) for m in s), str(d))
                                 for s, d in doc["digests"]),
                   device=str(doc["device"]))


@dataclasses.dataclass(frozen=True, eq=False)
class BinArrayProgram:
    """A compiled network: the instruction stream plus the (B, H, W, C) the
    plans were picked for.  Other batch sizes run correctly, only with
    plans picked for another size.  ``golden`` is the compile-time
    :class:`GoldenRecord` (None for ``compile(..., golden=False)`` and
    ``abstract_program``)."""

    instrs: tuple[Instr, ...]
    arch: str = ""
    input_shape: tuple[int, ...] = ()
    golden: GoldenRecord | None = None

    TREE_FIELDS = ("instrs",)

    def __len__(self) -> int:
        return len(self.instrs)

    @property
    def device(self) -> torch.device:
        return self.instrs[0].alpha.device

    @property
    def m_max(self) -> int:
        return max(i.M for i in self.instrs)

    def resolve_schedule(self, m_active) -> tuple[int, ...]:
        """Normalize ``m_active`` into one static level count per
        instruction: None -> all packed levels; an int -> global, clamped to
        each instruction's M (§IV-D); a sequence -> per-layer schedule
        (length must match), each entry clamped to [1, M_layer]."""
        if m_active is None:
            return tuple(i.M for i in self.instrs)
        if isinstance(m_active, int):
            if m_active < 1:
                raise ValueError(f"m_active must be >= 1, got {m_active}")
            return tuple(min(m_active, i.M) for i in self.instrs)
        sched = tuple(int(m) for m in m_active)
        if len(sched) != len(self.instrs):
            raise ValueError(
                f"m_active schedule has {len(sched)} entries for "
                f"{len(self.instrs)} instructions "
                f"({[i.name for i in self.instrs]})")
        if any(m < 1 for m in sched):
            raise ValueError(f"schedule entries must be >= 1: {sched}")
        return tuple(min(m, i.M) for m, i in zip(sched, self.instrs))

    def layer_stats(self) -> list[dict]:
        """One JSON-able dict per instruction: geometry, frozen tile plan,
        MACs and packed weight bytes."""
        out = []
        for idx, i in enumerate(self.instrs):
            d = {
                "index": idx, "name": i.name, "kind": i.kind,
                "pre": i.pre, "relu": bool(i.relu), "M": int(i.M),
                "in_shape": list(i.stats.in_shape),
                "out_shape": list(i.stats.out_shape),
                "macs": int(i.stats.macs),
                "weight_bytes": int(i.stats.weight_bytes),
                "plan": i.plan._asdict(),
            }
            if i.kind in ("conv", "dwconv"):
                d.update(kh=i.kh, kw=i.kw, stride=i.stride,
                         padded_in=list(i.stats.padded_in))
            if i.kind == "conv":
                d.update(padding=i.padding, pool=i.pool, group_size=int(i.group_size))
            if i.kind == "linear":
                d.update(K=int(i.K), group_size=int(i.group_size))
            out.append(d)
        return out

    def totals(self) -> dict:
        """Whole-program roll-up of the per-layer stats."""
        return {
            "arch": self.arch,
            "input_shape": list(self.input_shape),
            "n_instructions": len(self.instrs),
            "macs": int(sum(i.stats.macs for i in self.instrs)),
            "weight_bytes": int(sum(i.stats.weight_bytes for i in self.instrs)),
        }
