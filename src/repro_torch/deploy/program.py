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


Instr = ConvInstr | DWConvInstr | LinearInstr


@dataclasses.dataclass(frozen=True, eq=False)
class BinArrayProgram:
    """A compiled network: the instruction stream plus the (B, H, W, C) the
    plans were picked for.  Other batch sizes run correctly, only with
    plans picked for another size."""

    instrs: tuple[Instr, ...]
    arch: str = ""
    input_shape: tuple[int, ...] = ()

    def __len__(self) -> int:
        return len(self.instrs)

    @property
    def device(self) -> torch.device:
        return self.instrs[0].alpha.device

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
