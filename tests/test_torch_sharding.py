"""The port's sharding rules against the JAX package's, on the CPU, with no
process group.

The rules read only a mesh's axis sizes, so both packages get the
production meshes as sizes (the JAX side the fake mesh of
``tests/test_sharding.py``, the port a ``{axis: size}`` mapping) and the
full-size trees as shapes (the JAX side from ``jax.eval_shape``, the port
from ``api.param_shapes``).  Specs are compared entry by entry, an entry
normalized to None or a tuple of axis names (JAX writes ``("data",)`` as
``"data"``).  Shapes and dtypes of ``input_specs`` are compared exactly.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as jcb
from repro.core import binlinear as jbl
from repro.models import api as japi
from repro.sharding import rules as jshr
from repro_torch.configs import base as tcb
from repro_torch.core import binlinear as tbl
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.sharding import placement as tpl
from repro_torch.sharding import rules as tshr

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """What the JAX rules read of a mesh: its shape and axis names."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _norm(spec):
    return tuple(None if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


def _jax_leaves(tree):
    """(path, leaf) of a JAX tree, paths '/'-joined dict keys."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _same_specs(port_specs, jax_specs):
    got, want = _port_leaves(port_specs), _jax_leaves(jax_specs)
    assert got.keys() == want.keys()
    for path in want:
        assert _norm(got[path]) == _norm(want[path]), (path, got[path], want[path])
    return len(want)


def _jax_shapes(cfg, qc=None):
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    if qc is None:
        return jax.eval_shape(lambda k: japi.init_params(cfg, k), key)
    return jax.eval_shape(lambda k: japi.binarize_model_params(
        cfg, japi.init_params(cfg, k), qc=qc), key)


@pytest.fixture(scope="module")
def full_shapes():
    """arch -> (JAX ShapeDtypeStruct tree, the port's meta tree), full size."""
    return {a: (_jax_shapes(jcb.get_config(a)), tapi.param_shapes(tcb.get_config(a)))
            for a in tcb.ARCH_IDS}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", tcb.ARCH_IDS)
def test_param_pspecs_match_the_reference(full_shapes, arch, mesh):
    jshapes, tshapes = full_shapes[arch]
    jl, tl = _jax_leaves(jshapes), _port_leaves(tshapes)
    assert {p: tuple(s.shape) for p, s in tl.items()} == {p: s.shape for p, s in jl.items()}
    n = _same_specs(tshr.param_pspecs(tcb.get_config(arch), tshapes, MESHES[mesh]),
                    jshr.param_pspecs(jcb.get_config(arch), jshapes, FakeMesh(MESHES[mesh])))
    assert n == len(jl)


@pytest.fixture(scope="module")
def packed_qwen():
    """qwen3-14b's packed tree at M=2: (JAX cfg, shapes, port cfg, shapes)."""
    jqc, tqc = jbl.QuantConfig(mode="binary", M=2), tbl.QuantConfig(mode="binary", M=2)
    jcfg = jcb.get_config("qwen3_14b").replace(quant=jqc)
    tcfg = tcb.get_config("qwen3_14b").replace(quant=tqc)
    return jcfg, _jax_shapes(jcfg, jqc), tcfg, tapi.param_shapes(tcfg, qc=tqc)


@pytest.mark.parametrize("mesh", MESHES)
def test_packed_param_pspecs_match_the_reference(packed_qwen, mesh):
    """qwen3-14b's packed tree at M=2: shapes and dtypes from the shape rule
    equal binarize_model_params' under eval_shape, and so do the specs."""
    jcfg, jshapes, tcfg, tshapes = packed_qwen
    jl, tl = _jax_leaves(jshapes), _port_leaves(tshapes)
    assert {p: (tuple(s.shape), str(s.dtype).replace("torch.", "")) for p, s in tl.items()} \
        == {p: (s.shape, str(s.dtype)) for p, s in jl.items()}
    assert any(p.endswith("B_packed") for p in tl)
    _same_specs(tshr.param_pspecs(tcfg, tshapes, MESHES[mesh], fsdp=True),
                jshr.param_pspecs(jcfg, jshapes, FakeMesh(MESHES[mesh]), fsdp=True))
    _same_specs(tshr.param_pspecs(tcfg, tshapes, MESHES[mesh], fsdp=False),
                jshr.param_pspecs(jcfg, jshapes, FakeMesh(MESHES[mesh]), fsdp=False))


def test_packed_shapes_equal_binarize_params():
    """The shape rule against the real binarization, grouped and not, K not
    a multiple of 8, with a bias."""
    for K, N, gs in ((20, 6, None), (24, 5, 8)):
        qc = tbl.QuantConfig(mode="binary", M=3, group_size=gs, K_iters=2)
        p = {"w": torch.randn(K, N, generator=torch.Generator().manual_seed(0)),
             "b": torch.zeros(N)}
        got, want = tbl.packed_shapes(p, qc), tbl.binarize_params(p, qc)
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
            {k: (v.shape, v.dtype) for k, v in want.items()}


@pytest.mark.parametrize("shape", tcb.SHAPES)
@pytest.mark.parametrize("arch", tcb.ARCH_IDS)
def test_input_specs_match_the_reference(arch, shape):
    got = _port_leaves(tcb.input_specs(tcb.get_config(arch), shape))
    want = _jax_leaves(jcb.input_specs(jcb.get_config(arch), shape))
    assert all(t.device.type == "meta" for t in got.values())
    assert {p: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for p, t in got.items()} \
        == {p: (s.shape, str(s.dtype)) for p, s in want.items()}
    assert tcb.SHAPES == jcb.SHAPES


@pytest.mark.parametrize("arch,kv_seq_shard", [("codeqwen15_7b", False), ("gemma_2b", False),
                                               ("gemma_2b", True), ("mamba2_2_7b", False)])
@pytest.mark.parametrize("mesh", MESHES)
def test_batch_and_cache_specs_match_the_reference(arch, kv_seq_shard, mesh):
    jcfg = jcb.get_config(arch).replace(kv_seq_shard=kv_seq_shard)
    tcfg = tcb.get_config(arch).replace(kv_seq_shard=kv_seq_shard)
    n = _same_specs(
        tshr.batch_pspecs(tcfg, tcb.input_specs(tcfg, "decode_32k"), MESHES[mesh]),
        jshr.batch_pspecs(jcfg, jcb.input_specs(jcfg, "decode_32k"), FakeMesh(MESHES[mesh])))
    assert n >= 3
    for shape in ("train_4k", "long_500k"):
        _same_specs(tshr.batch_pspecs(tcfg, tcb.input_specs(tcfg, shape), MESHES[mesh],
                                      seq_sharded=True),
                    jshr.batch_pspecs(jcfg, jcb.input_specs(jcfg, shape),
                                      FakeMesh(MESHES[mesh]), seq_sharded=True))


def test_gemma_cache_falls_back_to_head_dim_or_seq():
    """gemma's one kv head does not divide the model axis: the trailing
    head_dim is split, or with kv_seq_shard the sequence."""
    cfg = tcb.get_config("gemma_2b")
    specs = tshr.batch_pspecs(cfg, tcb.input_specs(cfg, "decode_32k"), MESHES["16x16"])
    assert specs["cache"]["layers"]["k"] == tshr.P(None, ("data",), None, None, "model")
    cfg = cfg.replace(kv_seq_shard=True)
    specs = tshr.batch_pspecs(cfg, tcb.input_specs(cfg, "decode_32k"), MESHES["16x16"])
    assert specs["cache"]["layers"]["k"] == tshr.P(None, ("data",), "model", None, None)


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_activation_rules_match_the_reference(mesh, seq_sharded):
    got = tshr.activation_rules(MESHES[mesh], seq_sharded=seq_sharded)
    want = jshr.activation_rules(FakeMesh(MESHES[mesh]), seq_sharded=seq_sharded)
    assert got == want


def test_shard_divisibility_guard_and_no_op():
    rules = tshr.activation_rules({"data": 4, "model": 2})
    sizes = {"data": 4, "model": 2}
    # batch 8 divides data 4, heads 3 does not divide model 2 -> dropped
    assert tcm.logical_spec((8, 5, 3, 16), ("batch", None, "heads", None), rules, sizes) \
        == tshr.P(("data",), None, None, None)
    assert tcm.logical_spec((6, 16), ("batch", "ff"), rules, sizes) == tshr.P(None, "model")
    x = torch.randn(8, 4)
    tcm.set_axis_rules(None)
    assert tcm.shard(x, "batch", "ff") is x            # no rules
    tcm.set_axis_rules(rules, sizes)
    try:
        assert tcm.shard(x, "batch", "ff") is x        # a plain tensor
    finally:
        tcm.set_axis_rules(None)


class _Mesh:
    """What spec_placements reads of a DeviceMesh."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, i):
        return self._sizes[i]


def test_spec_placements():
    mesh = _Mesh({"pod": 2, "data": 4, "model": 2})
    assert tpl.spec_placements(tshr.P(None, ("pod", "data"), "model"), mesh) == \
        (Shard(1), Shard(1), Shard(2))
    assert tpl.spec_placements(tshr.P(), mesh) == (Replicate(),) * 3
    # a split over a size-1 axis is no split
    assert tpl.spec_placements(tshr.P("model", "data"), _Mesh({"data": 4, "model": 1})) == \
        (Shard(1), Replicate())
    with pytest.raises(ValueError):
        tpl.spec_placements(tshr.P(("data", "pod")), mesh)      # out of mesh order
    with pytest.raises(ValueError):
        tpl.spec_placements(tshr.P("model", "model"), mesh)     # one axis, two dims


def test_train_state_specs_cover_params_and_moments():
    from repro_torch.launch import steps as tsteps
    from repro_torch.optim import adamw

    cfg = tcb.get_config("gemma_2b")
    specs = tsteps.train_state_specs(cfg, MESHES["16x16"], adamw(1e-3))
    assert specs["opt_state"]["mu"] is specs["params"] is specs["opt_state"]["nu"]
    assert specs["params"]["layers"]["attn"]["wq"]["w"] == tshr.P(None, ("data",), "model")
    assert specs["step"] == tshr.P()


def test_gloo_gathers_through_host_is_scoped(monkeypatch):
    """Within the context DTensor's gathers are staged (a host tensor
    passes to the original as it is); on leaving, the originals are back;
    without an ``all_gather_tensor`` to stage it refuses."""
    import torch.distributed._functional_collectives as funcol

    seen = []

    def gather(t, gather_dim, group, tag=""):
        seen.append(t)
        return torch.cat([t, t], gather_dim)
    monkeypatch.setattr(funcol, "all_gather_tensor", gather)
    x = torch.arange(3.0)
    with tpl.gloo_gathers_through_host():
        assert funcol.all_gather_tensor is not gather
        assert torch.equal(funcol.all_gather_tensor(x, 0, None), torch.cat([x, x]))
    assert funcol.all_gather_tensor is gather and seen[0] is x
    monkeypatch.delattr(funcol, "all_gather_tensor")
    with pytest.raises(RuntimeError, match="all_gather_tensor"):
        with tpl.gloo_gathers_through_host():
            pass
