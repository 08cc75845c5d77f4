"""Small programs built from one numpy packed tree in both packages.

The serving and checkpoint tests of the port need the same program on both
sides: ±1 levels and alphas are drawn with numpy from a seed, packed by the
JAX package's packers (byte-identical to the port's, see
``tests/test_torch_binarize.py``), and compiled by each package's
``deploy.compile`` with the same LayerSpec list.

* ``conv_linear``: 3x3 SAME conv (D = 8, pool 2) on 8x8x3 into a flatten ->
  10 linear head.  The JAX package compiles it (``golden=False``) but cannot
  execute its conv on this CPU (its Pallas conv needs ``pl.Unblocked``).
* ``linear``: flatten -> 16 -> 10 on 4x4x3; both packages execute it (the
  JAX package's matmul in Pallas interpret mode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import deploy as jdeploy
from repro.core import binarize as jbz
from repro.core.binlinear import QuantConfig as JQuant
from repro.kernels import binary_conv as jbck
from repro.models import cnn as jcnn
from repro_torch import deploy
from repro_torch.checkpoint.manager import _flatten_with_paths, _unflatten
from repro_torch.convert import params_from_numpy
from repro_torch.core.binlinear import QuantConfig
from repro_torch.models import cnn as tcnn

M = 2
NETS = {  # name -> ([(layer, kind, LayerSpec kwargs, output width)], input shape)
    "conv_linear": ([("c0", "conv", dict(kh=3, kw=3, padding="SAME", pool=2), 8),
                     ("fc", "linear", dict(pre="flatten", relu=False), 10)],
                    (4, 8, 8, 3)),
    "linear": ([("fc0", "linear", dict(pre="flatten"), 16),
                ("fc1", "linear", dict(relu=False), 10)],
               (4, 4, 4, 3)),
}


def specs(net: str, module) -> tuple:
    """The net's LayerSpec list, as ``module`` (either package's
    ``models.cnn``) defines the class."""
    return tuple(module.LayerSpec(name, kind, **kw) for name, kind, kw, _ in NETS[net][0])


def packed_tree(net: str, seed: int = 0) -> dict:
    """A reference-format packed tree of numpy arrays; alphas keep the
    activations O(1)."""
    rng = np.random.default_rng(seed)
    layers, shape = NETS[net]
    shape = shape[1:]
    tree = {}
    for name, kind, kw, width in layers:
        if kind == "conv":
            kh, kw_, C = kw["kh"], kw["kw"], shape[-1]
            B = np.where(rng.random((M, kh * kw_ * C, width)) < 0.5, -1, 1).astype(np.int8)
            tree[name] = {"B_tap_packed": np.asarray(jbck.pack_taps(jnp.asarray(B), kh, kw_, C))}
            K = kh * kw_ * C
            shape = (shape[0] // kw["pool"], shape[1] // kw["pool"], width)
        else:
            K = int(np.prod(shape)) if kw.get("pre") == "flatten" else shape[-1]
            B = np.where(rng.random((M, K, width)) < 0.5, -1, 1).astype(np.int8)
            tree[name] = {"B_packed": np.asarray(jbz.pack_bits(jnp.asarray(B)))}
            shape = (width,)
        a0 = np.sqrt(2.0 / K) * (0.8 + 0.4 * rng.random((1, width)))
        tree[name]["alpha"] = np.stack([a0, 0.4 * a0]).astype(np.float32)
        tree[name]["b"] = (0.05 * rng.standard_normal(width)).astype(np.float32)
    return tree


def jax_program(net: str, tree: dict, *, golden=False):
    """The JAX package's program (Pallas interpret mode)."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jdeploy.compile(params, specs(net, jcnn), JQuant(mode="binary", M=M, interpret=True),
                           NETS[net][1], golden=golden)


def torch_program(net: str, tree: dict, *, golden=True):
    """The port's program on the CPU."""
    return deploy.compile(params_from_numpy(tree, device="cpu"), specs(net, tcnn),
                          QuantConfig(mode="binary", M=M), NETS[net][1],
                          device="cpu", golden=golden)


def zeroed(program):
    """``program`` with every tensor replaced by zeros and no golden record:
    a restore target, like ``deploy.abstract_program``, whose values cannot
    leak into what a restore returns."""
    flat, treedef = _flatten_with_paths(program)
    out = _unflatten(treedef, [torch.zeros_like(t) for t in flat.values()])
    return dataclasses.replace(out, golden=None)


def images(n: int, shape, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape[1:], dtype=np.float32) for _ in range(n)]
