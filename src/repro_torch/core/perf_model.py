"""BinArray analytical performance model (paper §IV-E, Eq. 14-18); the
port's copy of ``repro/core/perf_model.py``, reading the port's
``BinArrayProgram.layer_stats()``.

Predicts cycles/frame and fps for a BinArray[N_SA, D_arch, M_arch] given a
layer list.  Two variants:

  * ``cc_layer`` — MAC-exact: every output pixel needs W_B·H_B·C_I
    accumulations per binary level group; D_arch output channels in
    parallel; N_pass passes when D > D_arch·N_LSA (Eq. 17).  The dense-layer
    formula reproduces the paper's Table III composition exactly (the
    819.8 fps CNN-A figure decomposes into 466,668 conv + 21,270 dense cc at
    400 MHz with this dense model).
  * ``cc_layer_eq18`` — the literal Eq. 18 text (W_I·H_I·C_I·W_B·H_I·N_pass/N_T);
    kept for reference — the H_I factor where H_B is expected makes it
    inconsistent with the paper's own fps tables.

Throughput mode (paper §IV-D): M > M_arch costs ceil(M/M_arch) passes via
N_LSA (Eq. 15).
"""
from __future__ import annotations

import dataclasses
import functools
import math

CLOCK_HZ = 400e6  # paper §V-B2: timing closure at 400 MHz on XC7Z045-2


@dataclasses.dataclass(frozen=True)
class BinArrayConfig:
    N_SA: int
    D_arch: int
    M_arch: int

    def __str__(self):
        return f"BinArray[{self.N_SA},{self.D_arch},{self.M_arch}]"


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    W_I: int; H_I: int; C_I: int       # input feature dims
    W_B: int; H_B: int; D: int         # kernel dims, output channels
    stride: int = 1
    padding: int = 0
    depthwise: bool = False            # paper §V-A3: D_arch=1 for depth-wise

    @property
    def out_dims(self):
        """Eq. 14."""
        U = (self.W_I - self.W_B + 2 * self.padding) // self.stride + 1
        V = (self.H_I - self.H_B + 2 * self.padding) // self.stride + 1
        return U, V, self.D

    @property
    def macs(self) -> int:
        U, V, D = self.out_dims
        if self.depthwise:
            return U * V * D * self.W_B * self.H_B
        return U * V * D * self.W_B * self.H_B * self.C_I


@dataclasses.dataclass(frozen=True)
class DenseLayer:
    N_in: int
    N_out: int

    @property
    def macs(self) -> int:
        return self.N_in * self.N_out


def n_lsa(cfg: BinArrayConfig, M: int) -> float:
    """Eq. 15: logical SAs after folding M over M_arch passes."""
    return cfg.N_SA / math.ceil(M / cfg.M_arch)


def n_tiles(cfg: BinArrayConfig, layer: ConvLayer, M: int) -> int:
    """Eq. 16 (with the feasibility constraint W_I/N_T > 1)."""
    lsa = n_lsa(cfg, M)
    d_arch = 1 if layer.depthwise else cfg.D_arch
    nt = int(lsa // math.ceil(layer.D / d_arch))
    nt = max(nt, 1)
    while nt > 1 and (layer.W_I / nt <= 1 or layer.H_I / nt <= 1):
        nt -= 1
    return nt


def n_pass(cfg: BinArrayConfig, D: int, M: int, depthwise: bool = False) -> int:
    """Eq. 17."""
    d_arch = 1 if depthwise else cfg.D_arch
    lsa = max(n_lsa(cfg, M), 1e-9)
    return math.ceil(max(1.0, D / (d_arch * lsa)))


def cc_layer(cfg: BinArrayConfig, layer, M: int) -> float:
    """MAC-exact cycle count for one layer."""
    if isinstance(layer, DenseLayer):
        # each PE accumulates N_in inputs; D_arch·N_LSA neurons in parallel
        passes = n_pass(cfg, layer.N_out, M)
        return layer.N_in * passes
    U, V, D = layer.out_dims
    d_arch = 1 if layer.depthwise else cfg.D_arch
    passes = n_pass(cfg, D, M, layer.depthwise)
    nt = n_tiles(cfg, layer, M)
    per_pixel = layer.W_B * layer.H_B * (1 if layer.depthwise else layer.C_I)
    return U * V * per_pixel * passes / nt


def cc_layer_eq18(cfg: BinArrayConfig, layer: ConvLayer, M: int) -> float:
    """Literal paper Eq. 18 (documented inconsistency — see module doc)."""
    passes = n_pass(cfg, layer.D, M, layer.depthwise)
    nt = n_tiles(cfg, layer, M)
    return (layer.W_I * layer.H_I * layer.C_I * layer.W_B * layer.H_I
            * passes) / nt


def fps(cfg: BinArrayConfig, layers, M: int, *, clock_hz: float = CLOCK_HZ,
        exclude_final_dense: bool = False) -> float:
    """Frames/s for a network (paper offloads MobileNet's final dense+GAP to
    the CPU — exclude_final_dense reproduces that)."""
    use = list(layers)
    if exclude_final_dense:
        while use and isinstance(use[-1], DenseLayer):
            use.pop()
    total = sum(cc_layer(cfg, lyr, M) for lyr in use)
    return clock_hz / total


def total_macs(layers) -> int:
    return sum(lyr.macs for lyr in layers)


def cpu_fps(layers, *, gops: float = 1e9) -> float:
    """The paper's hypothetical 1-GOPS CPU baseline (Table III)."""
    return gops / total_macs(layers)


# ---------------------------------------------------------------------------
# Reference networks (paper §V-A1) as layer lists — derived from the deploy
# compiler's program.layer_stats(), not hand-maintained: the LayerSpec lists
# in models/cnn.py are the single topology source of truth, and an abstract
# compile (deploy.abstract_program: no binarization runs) turns them into
# the same per-layer geometry this model consumes.
# ---------------------------------------------------------------------------

def _infer_pad(in_dim: int, k: int, stride: int, out_dim: int) -> int:
    """Symmetric padding p with (in - k + 2p)//stride + 1 == out (Eq. 14)."""
    for p in range(0, k + 1):
        if (in_dim - k + 2 * p) // stride + 1 == out_dim:
            return p
    raise ValueError(f"no symmetric pad reproduces {in_dim}->{out_dim} "
                     f"(k={k}, stride={stride})")


def layers_from_stats(stats: list[dict]) -> list:
    """program.layer_stats() -> [ConvLayer | DenseLayer] for Eq. 14-18."""
    out = []
    for s in stats:
        if s["kind"] == "linear":
            out.append(DenseLayer(s["K"], s["out_shape"][-1]))
            continue
        _, H, W, C = s["in_shape"]
        U = s["out_shape"][1] * s.get("pool", 1)   # conv rows before the AMU
        out.append(ConvLayer(
            W_I=W, H_I=H, C_I=C, W_B=s["kw"], H_B=s["kh"],
            D=s["out_shape"][-1], stride=s["stride"],
            padding=_infer_pad(H, s["kh"], s["stride"], U),
            depthwise=(s["kind"] == "dwconv")))
    return out


def layers_from_program(program) -> list:
    """A compiled (or abstract) BinArrayProgram -> perf-model layer list."""
    return layers_from_stats(program.layer_stats())


@functools.lru_cache(maxsize=None)
def _net_stats(arch: str, width_mult: float, resolution: int) -> tuple:
    from repro_torch import deploy  # deferred: core must not hard-depend on deploy
    from repro_torch.core.binlinear import QuantConfig

    qc = QuantConfig(mode="binary", M=2, K_iters=1)
    shape = ((1, 48, 48, 3) if arch == "cnn_a"
             else (1, resolution, resolution, 3))
    prog = deploy.abstract_program(arch, qc, shape, width_mult=width_mult, device="cpu")
    return tuple(prog.layer_stats())


def cnn_a_layers():
    return layers_from_stats(list(_net_stats("cnn_a", 1.0, 48)))


def mobilenet_layers(*, alpha: float = 1.0, resolution: int = 224):
    """MobileNetV1 (CNN-B1: alpha=.5 res=128; CNN-B2: alpha=1 res=224)."""
    return layers_from_stats(list(_net_stats("mobilenet", alpha, resolution)))
