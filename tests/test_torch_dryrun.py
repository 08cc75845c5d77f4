"""The port's dry run (``launch/{cost_analysis,steps,dryrun,hillclimb,report}.py``,
``configs/base.cells``) and the module port's last leftovers
(``core/perf_model.py``, ``configs/{cnn_a,mobilenet_v1}.py``,
``kernels/binary_conv.repack_taps``, ``tools/torch_fsck_ckpt.py``),
against the JAX package's counterparts where they are plain Python or run
on the CPU.

The dry run counts one rank's eager step over ``meta`` DTensors on torch's
fake process group; each test that needs one holds it in the ``fake8``
fixture (or ``run_cell``'s own ``fake_world``), which destroys it, so no
later test in this process sees an initialized group.  The shape cells are
cut (``SHAPES`` monkeypatched to a few rows and tokens) and the configs
reduced: the counts depend on the code path, not on the size, and a
reduced config at the full cells' lengths would only take longer.
"""
import inspect
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.configs import base as jcb
from repro.core import perf_model as jpm
from repro.kernels import binary_conv as jbck
from repro.launch import hlo_analysis as jha
from repro.launch import report as jreport
from repro_torch import deploy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as tcb
from repro_torch.configs import cnn_a as tcnn_a, mobilenet_v1 as tmobilenet
from repro_torch.core import binarize as tbz
from repro_torch.core import perf_model as tpm
from repro_torch.core.binlinear import QuantConfig
from repro_torch.kernels import binary_conv as tbck
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun, hillclimb, report, steps
from repro_torch.models import api
from repro_torch.optim import adamw

SMALL = {"train_4k": dict(seq_len=16, global_batch=8, kind="train"),
         "prefill_32k": dict(seq_len=16, global_batch=8, kind="prefill"),
         "decode_32k": dict(seq_len=32, global_batch=8, kind="decode")}
FAMILIES = ("gemma_2b", "deepseek_v3_671b", "mamba2_2_7b", "zamba2_7b", "whisper_medium",
            "internvl2_2b")


def _jax_dryrun():
    """The JAX package's dryrun module, whose import sets XLA_FLAGS for 512
    host devices: jax's backend is started first and the variable is put
    back, so nothing else in this process sees it."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


@pytest.fixture
def small_cells(monkeypatch):
    for name, sh in SMALL.items():
        monkeypatch.setitem(tcb.SHAPES, name, sh)


@pytest.fixture
def fake8(small_cells):
    """A fake world of 8 ranks: its (2, 4) and (4, 2) cpu meshes."""
    with dryrun.fake_world(8):
        yield {shape: DeviceMesh("cpu", torch.arange(8).reshape(shape),
                                 mesh_dim_names=("data", "model"))
               for shape in ((2, 4), (4, 2))}


def test_fake_world_refuses_an_initialized_group_and_leaves_none():
    import torch.distributed as dist

    with dryrun.fake_world(8):
        assert dist.get_world_size() == 8
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_world(4):
                pass
    assert not dist.is_initialized()


# --- configs/base ------------------------------------------------------------

@pytest.mark.parametrize("arch", tcb.ARCH_IDS)
def test_cells_and_counts_equal_jax(arch):
    jc, tc = jcb.get_config(arch), tcb.get_config(arch)
    assert tcb.cells(tc) == jcb.cells(jc)
    assert tc.sub_quadratic == jc.sub_quadratic
    for active in (False, True):
        assert tc.param_count(active_only=active) == jc.param_count(active_only=active)


# --- cost_analysis -------------------------------------------------------------

def test_collective_stats_equal_jax():
    """The JAX test's two collectives (a 4-way all-gather to [32, 128] and
    an all-reduce of [8, 128], fp32) as events."""
    want = jha.collective_stats(_jax_hlo(), total_devices=4)
    got = ca.collective_stats([("all-gather", 32 * 128 * 4, 4),
                               ("all-reduce", 8 * 128 * 4, None)], total_devices=4)
    assert got.ops == want.ops
    assert got.result_bytes == want.result_bytes
    assert got.wire_bytes == want.wire_bytes
    assert got.total_result_bytes() == want.total_result_bytes()


def _jax_hlo():
    import test_hlo_analysis

    return test_hlo_analysis.TestCollectiveStats.HLO


def test_counter_counts_the_local_shard_of_a_linear(fake8):
    """x [T, K] rows on "data", w [K, N] columns on "model" of a (4, 2)
    mesh: the rank's product is [T/4, K] x [K, N/2], 2·T·K·N/8 FLOPs, with
    no collective."""
    T, K, N = 64, 32, 16
    mesh = fake8[(4, 2)]
    x = distribute_tensor(torch.empty(T, K, device="meta"), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    w = distribute_tensor(torch.empty(K, N, device="meta"), mesh, [Replicate(), Shard(1)],
                          src_data_rank=None)
    for _ in range(2):     # a second pass, after DTensor has cached its sharding decision
        with ca.CostCounter() as c:
            y = x @ w
        assert c.flops == {"fp32": 2 * T * K * N / 8}
        assert c.collectives == [] and ca.count_op(c, "mm") == 1
        assert c.bytes_accessed == 4 * (T * K // 4 + K * N // 2 + T * N // 8)
        assert tuple(y.to_local().shape) == (T // 4, N // 2)


def test_packed_linear_on_meta_is_counted_by_the_kernel_formula():
    cfg = QuantConfig(mode="binary", M=2)
    T, K, N = 6, 40, 24
    p = {"B_packed": torch.empty((2, 5, N), dtype=torch.uint8, device="meta"),
         "alpha": torch.empty((2, 1, N), device="meta")}
    x = torch.empty((2, 3, K), dtype=torch.bfloat16, device="meta")
    from repro_torch.core import binlinear as bl

    with ca.CostCounter() as c:
        y = bl.apply_linear(p, x, cfg)
    assert y.shape == (2, 3, N) and y.dtype == torch.bfloat16 and y.device.type == "meta"
    # the kernel reads bf16 x as it is: x counted at 2 bytes, and the only
    # cast is the fp32 result's to x's dtype
    macs, nbytes = T * K * N, 2 * T * K + 2 * 5 * N + 4 * 2 * N + 4 * T * N
    assert c.binary == {"calls": 1, "macs": macs, "bytes": nbytes}
    assert c.flops == {"fp32": 2 * macs}
    assert ca.count_op(c, "binary_matmul") == 1 and ca.count_op(c, "_to_copy") == 1


def test_counters_receive_kernel_calls_only_while_active():
    from repro_torch.kernels import ops

    B = torch.empty((2, 5, 24), dtype=torch.uint8, device="meta")
    alpha = torch.empty((2, 1, 24), device="meta")
    x = torch.empty((6, 40), device="meta")
    with ca.CostCounter() as outer:
        with pytest.raises(RuntimeError, match="inside"):
            with ca.CostCounter() as inner:
                ops.binary_matmul(x, B, alpha, K=40, group_size=40)
                raise RuntimeError("inside")
        ops.binary_matmul(x, B, alpha, K=40, group_size=40)
    ops.binary_matmul(x, B, alpha, K=40, group_size=40)
    assert ops.reporters == []
    assert inner.binary["calls"] == 1 and outer.binary["calls"] == 2


def test_counter_changes_no_result():
    cfg = tcb.reduced(tcb.get_config("gemma_2b")).replace(dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = api.forward(cfg, params, {"tokens": tokens})
        with ca.CostCounter() as c:
            got, _ = api.forward(cfg, params, {"tokens": tokens})
    assert torch.equal(got, want)
    assert c.flops["fp32"] > 0 and c.peak_live_bytes > 0 and c.collectives == []


# --- lowering ------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_steps_lower_and_compile_for_each_family(fake8, arch):
    cfg = tcb.reduced(tcb.get_config(arch))
    mesh = fake8[(2, 4)]
    packed = cfg.replace(quant=QuantConfig(mode="binary", M=2))
    compiled = {
        "train": steps.lower_train_step(cfg, mesh, adamw(1e-4),
                                        tcb.input_specs(cfg, "train_4k"),
                                        microbatch=2 if arch == "gemma_2b" else None).compile(),
        "decode": steps.lower_serve_step(cfg, mesh, tcb.input_specs(cfg, "decode_32k")
                                         ).compile(),
        "packed": steps.lower_serve_step(packed, mesh, tcb.input_specs(packed, "decode_32k"),
                                         fsdp_params=False).compile()}
    for name, c in compiled.items():
        cost, mem = c.cost_analysis(), c.memory_analysis()
        assert cost["flops"] > 0 and cost["bytes accessed"] > 0, name
        assert mem.argument_size_in_bytes > 0 and mem.temp_size_in_bytes > 0, name
        assert c.collectives, name
    assert compiled["packed"].counter.binary["calls"] > 0
    assert compiled["decode"].counter.binary["calls"] == 0


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_seq_sharded_prefill_counts_each_rank_its_rows(fake8, monkeypatch, shape):
    """A B = 1 packed prefill with the sequence-sharded rules: every kernel
    call on the rank's 16 / data rows of the sequence, so the counted
    product FLOPs per rank are 1 / data of the count without them."""
    cfg = tcb.reduced(tcb.get_config("gemma_2b")).replace(quant=QuantConfig(mode="binary", M=2))
    specs = {"tokens": torch.empty((1, 16), dtype=torch.int32, device="meta")}
    rows, real = [], ca.CostCounter.binary_matmul

    def counted(self, T, K, N, B_packed, alpha, **kw):
        rows.append(T)
        return real(self, T, K, N, B_packed, alpha, **kw)
    monkeypatch.setattr(ca.CostCounter, "binary_matmul", counted)
    mesh, n_data = fake8[shape], shape[0]
    counts = {}
    for seq in (False, True):
        rows.clear()
        c = steps.lower_serve_step(cfg, mesh, specs, kind="prefill", fsdp_params=False,
                                   seq_sharded=seq).compile()
        counts[seq] = (c.counter.binary["macs"], list(rows))
    assert counts[False][1] == [16] * 7 * cfg.n_layers
    assert counts[True][1] == [16 // n_data] * 7 * cfg.n_layers
    assert counts[True][0] * n_data == counts[False][0] > 0


def test_extrapolation_equals_the_direct_count(fake8):
    """Eager counting sees every layer: the affine fit over the depth pair
    (2, 4) gives the direct count at depth 6 exactly."""
    cfg = tcb.reduced(tcb.get_config("gemma_2b")).replace(n_layers=6)
    mesh = fake8[(2, 4)]
    ext = dryrun.extrapolated_costs(cfg, mesh, "decode_32k", n_dev=8)
    direct = dryrun._lower_for(cfg, mesh, "decode_32k",
                               tcb.input_specs(cfg, "decode_32k")).compile()
    assert ext["depths_used"] == [2, 4]
    assert ext["flops"] == direct.cost_analysis()["flops"]
    assert ext["flops_by_class"] == {"fp32": direct.flops_by_class.get("fp32", 0.0),
                                     "tensor": direct.flops_by_class.get("tensor", 0.0)}
    assert ext["bytes"] == direct.cost_analysis()["bytes accessed"]
    assert ext["wire_bytes"] == ca.collective_stats(direct.collectives, 8).wire_bytes


# --- records and the report ------------------------------------------------------

def _reduced_overrides(arch: str) -> dict:
    full = tcb.get_config(arch)
    small = tcb.reduced(full)
    return {f: getattr(small, f) for f in full.__dataclass_fields__
            if getattr(small, f) != getattr(full, f)}


def _jax_record_keys(jdry) -> set:
    src = inspect.getsource(jdry.run_cell)
    first = src[src.index("record: dict = {"):]
    first = first[:first.index("}")]
    terms = jha.RooflineTerms(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, "compute",
                              jha.CollectiveStats({}, {}, 0.0), {})
    return (set(re.findall(r'"(\w+)":', first)) | set(re.findall(r'record\["(\w+)"\]', src))
            | set(terms.as_dict())) - {"reason"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Records of two reduced cells on the 256-rank mesh (gemma's decode,
    and hillclimb cell D's packed iteration of it) and a long_500k skip, in
    a fresh results directory."""
    results = tmp_path_factory.mktemp("torch_dryrun")
    over = _reduced_overrides("gemma_2b")
    tag, packed = hillclimb.CELLS["D"][3][1]
    with pytest.MonkeyPatch.context() as mp:
        for name, sh in SMALL.items():
            mp.setitem(tcb.SHAPES, name, sh)
        mp.setattr(dryrun, "RESULTS_DIR", str(results))
        out = [dryrun.run_and_save("gemma_2b", "decode_32k", "single", mesh_device="cpu",
                                   overrides=over),
               dryrun.run_and_save("gemma_2b", "long_500k", "single", mesh_device="cpu"),
               dryrun.run_and_save("gemma_2b", "decode_32k", "single", tag=tag,
                                   mesh_device="cpu", overrides={**over, **packed})]
    return out, results


def test_records_have_every_key_of_the_jax_record(records):
    jdry = _jax_dryrun()
    recs, _ = records
    want = _jax_record_keys(jdry)
    for r in (recs[0], recs[2]):
        assert r["status"] == "ok", r.get("traceback")
        assert want <= set(r), want - set(r)
        assert r["mesh_device"] == "cpu" and r["n_devices"] == 256
        assert r["microbatch"] is None
    gemma = tcb.reduced(tcb.get_config("gemma_2b"))
    assert recs[0]["model_flops"] == 2 * gemma.param_count(active_only=True) * 8
    assert recs[0]["binary_matmul"]["calls"] == 0
    assert recs[2]["binary_matmul"]["calls"] == 7 * 2     # 7 linears x 2 reduced layers
    assert recs[1] == jdry.run_cell("gemma_2b", "long_500k", "single")


def test_report_prints_the_jax_tables(records, monkeypatch, capsys):
    _, results = records
    monkeypatch.setattr(report, "RESULTS_DIR", str(results))
    monkeypatch.setattr(jreport, "RESULTS_DIR", str(results))
    printed = []
    for mod in (jreport, report):
        mod.dryrun_table()
        mod.roofline_table()
        mod.perf_table()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert printed[0].count("\n") == 2 + 2 + 2 + 1 + 2 + 1


# --- the paper's FPGA model and the CNN specs ---------------------------------------

def _cfgs():
    return [jpm.BinArrayConfig(*a) for a in ((1, 32, 2), (4, 32, 2), (8, 16, 4))]


@pytest.mark.parametrize("net", ["cnn_a", "cnn_b1", "cnn_b2"])
def test_perf_model_equals_jax(net):
    if net == "cnn_a":
        want, got = jpm.cnn_a_layers(), tpm.cnn_a_layers()
    else:
        spec = getattr(tmobilenet, net.upper())
        kw = dict(alpha=spec["width_mult"], resolution=spec["resolution"])
        want, got = jpm.mobilenet_layers(**kw), tpm.mobilenet_layers(**kw)
    assert [dataclass_fields(a) for a in got] == [dataclass_fields(b) for b in want]
    assert tpm.total_macs(got) == jpm.total_macs(want)
    for jc in _cfgs():
        tc = tpm.BinArrayConfig(jc.N_SA, jc.D_arch, jc.M_arch)
        for M in (1, 2, 4):
            assert [tpm.cc_layer(tc, lyr, M) for lyr in got] == \
                [jpm.cc_layer(jc, lyr, M) for lyr in want]
            for excl in (False, True):
                assert tpm.fps(tc, got, M, exclude_final_dense=excl) == \
                    jpm.fps(jc, want, M, exclude_final_dense=excl)


def dataclass_fields(layer) -> tuple:
    return (type(layer).__name__,) + tuple(vars(layer).values())


@pytest.fixture(scope="module")
def cnn_a_taps():
    """CNN-A compiled on the CPU from a packed tree of random bits (the
    abstract program's shapes: no binarization runs)."""
    qc = QuantConfig(mode="binary", M=2, K_iters=1)
    abstract = deploy.abstract_program("cnn_a", qc, (2, 48, 48, 3), device="cpu")
    gen = torch.Generator().manual_seed(0)
    tree = {}
    for i in abstract.instrs:
        C, K = i.stats.in_shape[-1], (i.kh * i.kw * i.stats.in_shape[-1] if i.kind == "conv"
                                      else i.K)
        D = i.alpha.shape[-1]
        B = torch.randint(0, 2, (2, K, D), generator=gen, dtype=torch.int8) * 2 - 1
        p = {"alpha": torch.rand(i.alpha.shape, generator=gen),
             "b": torch.randn(i.bias.shape, generator=gen)}
        if i.kind == "conv":
            p["B_tap_packed"] = tbck.pack_taps(B, i.kh, i.kw, C)
        else:
            p["B_packed"] = tbz.pack_bits(tbz.pad_rows_to_byte(B))
        tree[i.name] = p
    return deploy.compile(tree, "cnn_a", qc, (2, 48, 48, 3), device="cpu", golden=False), qc


def test_layers_from_compiled_cnn_a_stats_equal_jax(cnn_a_taps):
    got = tpm.layers_from_stats(cnn_a_taps[0].layer_stats())
    assert [dataclass_fields(a) for a in got] == \
        [dataclass_fields(b) for b in jpm.cnn_a_layers()]


def test_cnn_specs_equal_jax():
    from repro.configs import cnn_a as jcnn_a, mobilenet_v1 as jmobilenet

    assert tcnn_a.CONFIG == jcnn_a.CONFIG
    assert (tmobilenet.CNN_B1, tmobilenet.CNN_B2) == (jmobilenet.CNN_B1, jmobilenet.CNN_B2)


# --- repack_taps ----------------------------------------------------------------------

@pytest.mark.parametrize("kh,kw,C,D", [(7, 7, 3, 5), (4, 4, 5, 150)])   # CNN-A's two convs
def test_repack_taps_bytes_equal_jax(kh, kw, C, D):
    rng = np.random.default_rng(kh * C)
    K = kh * kw * C
    B = np.where(rng.random((2, K, D)) < 0.5, -1, 1).astype(np.int8)
    flat = tbz.pack_bits(tbz.pad_rows_to_byte(torch.from_numpy(B)))
    want = np.asarray(jbck.repack_taps(jnp.asarray(flat.numpy()), kh, kw, C))
    got = tbck.repack_taps(flat, kh, kw, C)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_compile_repacks_a_flat_only_conv_tree(cnn_a_taps):
    """CNN-A's packed tree with each conv's flat stream in place of its
    per-tap layout compiles to the same program."""
    taps, qc = cnn_a_taps
    flat = {}
    for instr in taps.instrs:
        p = {"alpha": instr.alpha, "b": instr.bias}
        if instr.kind == "conv":
            B = tbck.unpack_taps(instr.B_tap_packed, instr.stats.in_shape[-1])
            p["B_packed"] = tbz.pack_bits(tbz.pad_rows_to_byte(B))
        else:
            p["B_packed"] = instr.B_packed
        flat[instr.name] = p
    program = deploy.compile(flat, "cnn_a", qc, (2, 48, 48, 3), device="cpu", golden=False)
    assert len(program.instrs) == len(taps.instrs)
    for a, b in zip(program.instrs, taps.instrs):
        assert a.name == b.name and a.plan == b.plan and a.stats == b.stats
        wa = a.B_tap_packed if a.kind == "conv" else a.B_packed
        wb = b.B_tap_packed if b.kind == "conv" else b.B_packed
        assert torch.equal(wa, wb) and torch.equal(a.alpha, b.alpha)
        assert torch.equal(a.bias, b.bias)


# --- tools/torch_fsck_ckpt.py -------------------------------------------------------------

def test_fsck_tools_agree_on_the_port_checkpoints(tmp_path, capsys):
    import tools.fsck_ckpt as jfsck
    import tools.torch_fsck_ckpt as tfsck

    good, bad = tmp_path / "good", tmp_path / "bad"
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "step": torch.tensor(3, dtype=torch.int32)}
    CheckpointManager(str(good)).save(1, state)
    CheckpointManager(str(bad)).save(1, state)
    leaf = next(bad.rglob("*.npz"))
    leaf.write_bytes(leaf.read_bytes()[:-40])
    for d, rc in ((good, 0), (bad, 1)):
        outs = []
        for tool in (jfsck, tfsck):
            js = tmp_path / f"{d.name}_{tool.__name__}.json"
            assert tool.main([str(d), "--json", str(js)]) == rc
            outs.append((capsys.readouterr(), json.loads(js.read_text())))
        assert outs[0] == outs[1]
