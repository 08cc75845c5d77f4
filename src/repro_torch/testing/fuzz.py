"""Differential-fuzz network generator: random LayerSpec lists + params.

Port of ``repro/testing/fuzz.py``.  ``deploy.compile`` accepts any
LayerSpec sequence, and the kernels promise the same answer under every
tile plan, so legal-by-construction random networks drive

    random specs -> compile -> verify_program (zero ERRORs) -> execute
                 -> torch.equal to ``kernel_forward`` (each layer
                    through ``kernels.ops`` with its own plan pick)
                 -> allclose to ``execute_reference`` (the plain versions)

over shapes the hand-built networks never reach: pool 3, ``kh != kw``,
C = 3 or 4, a 1x1 conv at stride 2, depth-wise layers at stride 2 on odd
maps, M = 1, execute batches larger than the compiled one.

``random_network`` draws from ``random.Random(seed)`` exactly as the JAX
generator does, so **the same seed gives the same** :class:`FuzzNet`
(specs, ``input_shape``, ``exec_batch``, ``M``) in both packages and a
failure replays in either.  Its D in {8, 16, 32} rule is the TPU's lane
legality; the port keeps it for the parity of the draw.  Only the fp
weights differ: ``FuzzNet.init_params`` draws from a ``torch.Generator``.

Legality constraints encoded here (mirrors the compiler's own checks):
  * conv kernels fit the current map (kh <= Hp, kw <= Wp for VALID);
  * the AMU pool window divides the conv output (paper §III-B:
    downsampling only — the compiler raises otherwise);
  * depth-wise layers are 3x3 SAME (MobileNet's only variant);
  * a ``flatten``/``gap`` pre-op transitions to the linear tail, and the
    last layer drops ReLU (logits).
"""
from __future__ import annotations

import dataclasses
import math
import random

import torch

from repro_torch import resolve_device
from repro_torch.core.binconv import same_pads
from repro_torch.kernels import ops
from repro_torch.models.cnn import LayerSpec, apply_pre


@dataclasses.dataclass(frozen=True)
class FuzzNet:
    """One generated network: topology + matching fp params + geometry."""

    specs: tuple[LayerSpec, ...]
    input_shape: tuple[int, int, int, int]   # (B, H, W, C) compile target
    exec_batch: int                          # ragged-batch execute size
    M: int                                   # packed level count

    def init_params(self, gen: torch.Generator, *, device="cuda") -> dict:
        """fp parameter tree matching ``specs`` (shapes re-derived by the
        same walk the generator ran), drawn on the CPU from ``gen`` in
        layer order, then moved to ``device``."""
        dev = resolve_device(device)

        def normal(shape, scale):
            return (torch.randn(shape, generator=gen) * scale).to(dev)

        params = {}
        _, H, W, C = self.input_shape
        for spec, (shp_in, shp_out) in _shape_walk(self.specs, (H, W, C)):
            if spec.kind == "conv":
                cin, cout = shp_in[2], shp_out[2]
                w = normal((spec.kh, spec.kw, cin, cout), 1.0 / (spec.kh * spec.kw))
            elif spec.kind == "dwconv":
                cout = shp_in[2]
                w = normal((spec.kh, spec.kw, 1, cout), 0.3)
            else:
                kin, cout = shp_in
                w = normal((kin, cout), 1.0 / math.sqrt(kin))
            params[spec.name] = {"w": w, "b": torch.zeros(cout, device=dev)}
        return params


def _shape_walk(specs, hwc):
    """[(spec, ((in-geom), (out-geom)))] — conv/dw geoms are (H, W, C),
    linear geoms are (K, N), re-derived from the names' embedded dims."""
    out = []
    cur = hwc
    for spec in specs:
        dims = [int(d) for d in spec.name.split("_")[-1].split("x")]
        if spec.kind == "conv":
            D = dims[0]
            H, W, C = cur
            Hp, Wp = _padded(H, W, spec)
            U = (Hp - spec.kh) // spec.stride + 1
            V = (Wp - spec.kw) // spec.stride + 1
            nxt = (U // spec.pool, V // spec.pool, D)
            out.append((spec, ((H, W, C), nxt)))
            cur = nxt
        elif spec.kind == "dwconv":
            H, W, C = cur
            # dw layers are ALWAYS SAME (the compiler ignores spec.padding)
            Hp, Wp = _padded(H, W, dataclasses.replace(spec, padding="SAME"))
            U = (Hp - spec.kh) // spec.stride + 1
            V = (Wp - spec.kw) // spec.stride + 1
            nxt = (U, V, C)
            out.append((spec, ((H, W, C), nxt)))
            cur = nxt
        else:
            N = dims[0]
            if spec.pre == "flatten":
                K = cur[0] * cur[1] * cur[2] if len(cur) == 3 else cur[0]
            elif spec.pre == "gap":
                K = cur[2]
            else:
                K = cur[0]
            out.append((spec, ((K, N), (N,))))
            cur = (N,)
    return out


def _padded(H, W, spec):
    if spec.padding != "SAME":
        return H, W
    (pt, pb) = same_pads(H, spec.kh, spec.stride)
    (pl, pr) = same_pads(W, spec.kw, spec.stride)
    return H + pt + pb, W + pl + pr


def random_network(seed: int, *, max_layers: int = 5) -> FuzzNet:
    """Generate one legal network from ``seed``.

    Spatial section: 1-3 conv/dwconv layers over small maps (H, W in
    [8, 20], C in {3, 4, 8}, D in {8, 16, 32}, strides {1, 2}, pools
    {1, 2, 3} restricted to divisors of the conv output).  Tail: a
    flatten/gap transition linear plus 0-2 more, last one without ReLU.
    Every draw is the JAX generator's, in its order.
    """
    rng = random.Random(seed)
    H = rng.randint(8, 20)
    W = rng.randint(8, 20)
    C = rng.choice((3, 4, 8))
    M = rng.choice((1, 2, 2))            # bias toward the paper's M=2
    specs: list[LayerSpec] = []
    cur = (H, W, C)
    n_spatial = rng.randint(1, max(1, max_layers - 2))
    for li in range(n_spatial):
        h, w, c = cur
        use_dw = c % 8 == 0 and min(h, w) >= 3 and rng.random() < 0.4
        if use_dw:
            stride = rng.choice((1, 2)) if min(h, w) >= 6 else 1
            spec = LayerSpec(f"dw{li}_{c}x{c}", "dwconv", kh=3, kw=3,
                             stride=stride)
            specs.append(spec)
            cur = _shape_walk((spec,), cur)[0][1][1]
            continue
        padding = rng.choice(("VALID", "SAME"))
        kmax = min(5, h, w)
        kh = rng.randint(1, kmax)
        kw = rng.randint(1, kmax)
        stride = rng.choice((1, 2)) if min(h, w) > 6 else 1
        D = rng.choice((8, 16, 32))
        hp, wp = (h, w) if padding == "VALID" else _padded(
            h, w, LayerSpec("t", "conv", kh=kh, kw=kw, stride=stride,
                            padding="SAME"))
        U = (hp - kh) // stride + 1
        V = (wp - kw) // stride + 1
        if U < 1 or V < 1:
            continue
        pools = [p for p in (1, 2, 3) if U % p == 0 and V % p == 0]
        pool = rng.choice(pools)
        spec = LayerSpec(f"conv{li}_{D}", "conv", kh=kh, kw=kw,
                         stride=stride, padding=padding, pool=pool)
        specs.append(spec)
        cur = _shape_walk((spec,), cur)[0][1][1]
        if min(cur[0], cur[1]) < 2:
            break
    # linear tail: flatten or gap transition, then 0-2 plain linears
    pre = rng.choice(("flatten", "flatten", "gap")) if specs else "flatten"
    if not specs:  # degenerate: all-spatial generation failed -> pure MLP
        cur = (H, W, C)
    n_tail = rng.randint(1, 3)
    for ti in range(n_tail):
        N = rng.choice((8, 16, 32))
        last = ti == n_tail - 1
        specs.append(LayerSpec(f"fc{ti}_{N}", "linear",
                               pre=pre if ti == 0 else "none",
                               relu=not last))
    B = rng.randint(1, 3)
    exec_b = rng.randint(1, 5)
    return FuzzNet(specs=tuple(specs), input_shape=(B, H, W, C),
                   exec_batch=exec_b, M=M)


def features(net: FuzzNet) -> set[str]:
    """The rare shapes a network draws, by name (the fuzz tier's coverage
    tally): ``pool3``, ``kh_ne_kw``, ``stride2_pool`` (a stride-2 conv with
    a pool after it), ``valid``, ``c_not_mult8`` (a conv over C not a
    multiple of 8), ``1x1_stride2``, ``dw_stride2``, ``m1`` and
    ``exec_gt_compiled`` (an execute batch larger than the compiled one)."""
    out = set()
    _, H, W, C = net.input_shape
    for spec, (shp_in, _) in _shape_walk(net.specs, (H, W, C)):
        if spec.kind == "conv":
            if spec.pool == 3:
                out.add("pool3")
            if spec.kh != spec.kw:
                out.add("kh_ne_kw")
            if spec.stride == 2 and spec.pool > 1:
                out.add("stride2_pool")
            if spec.padding == "VALID":
                out.add("valid")
            if shp_in[2] % 8:
                out.add("c_not_mult8")
            if (spec.kh, spec.kw, spec.stride) == (1, 1, 2):
                out.add("1x1_stride2")
        elif spec.kind == "dwconv" and spec.stride == 2:
            out.add("dw_stride2")
    if net.M == 1:
        out.add("m1")
    if net.exec_batch > net.input_shape[0]:
        out.add("exec_gt_compiled")
    return out


FEATURES = ("pool3", "kh_ne_kw", "stride2_pool", "valid", "c_not_mult8",
            "1x1_stride2", "dw_stride2", "m1", "exec_gt_compiled")


def kernel_forward(specs, packed: dict, x: torch.Tensor, m_active=None) -> torch.Tensor:
    """A per-call forward over a packed tree: each layer through
    ``kernels.ops.binary_*`` with no frozen plan, so each call picks its own
    plan for the batch it is given — the counterpart of the JAX package's
    fused per-call ``spec_forward``.  Every tiling of a kernel gives the same
    bits, so on a card ``deploy.execute`` must equal it ``torch.equal``
    under the same global ``m_active`` (None = all levels)."""
    y = x.to(torch.float32)
    for s in specs:
        p = packed[s.name]
        y = apply_pre(s.pre, y)
        n_out = p["alpha"].shape[-1]
        bias = p.get("b")
        if bias is None:
            bias = torch.zeros(n_out, device=y.device)
        if s.kind == "conv":
            y = ops.binary_conv2d(y, p["B_tap_packed"], p["alpha"], bias, kh=s.kh,
                                  kw=s.kw, stride=s.stride, padding=s.padding,
                                  pool=s.pool, m_active=m_active, relu=s.relu)
        elif s.kind == "dwconv":
            y = ops.binary_dwconv2d(y, p["B_tap_packed"], p["alpha"], bias, kh=s.kh,
                                    kw=s.kw, stride=s.stride, m_active=m_active,
                                    relu=s.relu)
        else:
            K = y.shape[-1]
            y = ops.binary_matmul(y, p["B_packed"], p["alpha"], K=K,
                                  group_size=K // p["alpha"].shape[1], m_active=m_active)
            y = y + bias
            if s.relu:
                y = torch.relu(y)
    return y
