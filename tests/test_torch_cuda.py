"""The CUDA kernels on the card against their plain PyTorch versions.

Marked ``gpu``; the ``card`` fixture skips every test when there is no CUDA
device.  The file imports no jax, so on a machine without it run

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py

Tolerance rtol 1e-5, atol 1e-4 (the reference's kernel tolerance; both
sides sum in fp32, TF32 switched off for the plain versions).  Two tile
plans of a kernel must give bit-identical outputs, since each output's
reduction runs in one fixed order whatever the tiling.
"""
import pytest
import torch

from repro_torch import deploy
from repro_torch.core import binarize as bz
from repro_torch.core.binlinear import QuantConfig
from repro_torch.kernels import binary_conv as bck
from repro_torch.kernels import binary_dwconv as bdw
from repro_torch.kernels import binary_matmul as bmk
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import cnn

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _signs(gen, shape):
    return (torch.randint(0, 2, shape, generator=gen, dtype=torch.int8) * 2 - 1)


def _alpha(gen, shape):
    return torch.rand(shape, generator=gen) * 0.5 + 0.1


@pytest.mark.parametrize("T,K,N,M,group_size,m_active", [
    (5, 13, 7, 2, None, None),          # K = 13: fewer bytes than reduction chunks
    (64, 1350, 340, 2, 675, 1),         # group 675 crosses chunk bounds
    (16, 24, 40, 3, 12, 2),             # group 12 at K = 24
    (16, 1024, 1000, 2, None, None), (3, 490, 43, 2, None, 2),
    (1, 340, 490, 2, None, None),       # T = 1
    (64, 1350, 1, 2, 675, None),        # N = 1
    (7, 1350, 43, 3, 675, 3)])
def test_binary_matmul_kernel_matches_plain(card, T, K, N, M, group_size, m_active):
    gen = torch.Generator().manual_seed(T * K + N)
    gs = group_size or K
    x = torch.randn(T, K, generator=gen).to(card)
    packed = bz.pack_bits(bz.pad_rows_to_byte(_signs(gen, (M, K, N)))).to(card)
    alpha = _alpha(gen, (M, K // gs, N)).to(card)
    want = ref.binary_matmul_ref(x, packed, alpha, K=K, group_size=gs, m_active=m_active)
    before = ops.launch_counts()["binary_matmul"]
    outs = [ops.binary_matmul(x, packed, alpha, K=K, group_size=gs, m_active=m_active,
                              plan=plan) for plan in ((8, 64), (1, 32), (4, 32))]
    torch.cuda.synchronize()
    assert ops.launch_counts()["binary_matmul"] - before == 3
    torch.testing.assert_close(outs[0], want, rtol=RTOL, atol=ATOL)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


CONV_PLANS = ((128, 128), (64, 32), (96, 128), (128, 64), (64, 128), (96, 32), (128, 32))


@pytest.mark.parametrize("B,H,W,C,D,kh,kw,stride,padding,pool,M,m_active,relu,group_size", [
    (5, 48, 48, 3, 5, 7, 7, 1, "VALID", 2, 2, None, True, None),    # conv1
    (3, 21, 21, 5, 150, 4, 4, 1, "VALID", 6, 2, 1, True, None),     # conv2
    (7, 21, 21, 5, 43, 4, 4, 1, "VALID", 6, 2, None, False, None),  # pool 6, ragged batch, D = 43
    (3, 224, 224, 3, 32, 3, 3, 2, "SAME", 1, 2, None, True, None),  # stem
    (2, 225, 223, 3, 32, 3, 3, 2, "SAME", 1, 2, None, True, None),  # stem, odd sizes
    (3, 17, 15, 3, 43, 3, 3, 2, "SAME", 1, 2, 1, False, None),      # odd, pads (1, 1)
    (3, 7, 7, 1024, 1024, 1, 1, 1, "VALID", 1, 2, None, True, None),  # pw12
    (2, 14, 14, 12, 64, 1, 1, 1, "VALID", 1, 2, None, True, None),  # 1x1, C = 12
    (3, 9, 9, 40, 100, 1, 1, 1, "VALID", 1, 2, 1, False, 20),       # 1x1, C = 40, groups of 20
    (2, 8, 8, 5, 6, 4, 4, 1, "SAME", 2, 3, 2, False, 20),           # groups span taps
    (1, 6, 6, 12, 9, 1, 1, 1, "VALID", 1, 2, None, False, 6)])
def test_binary_conv_kernel_matches_plain(card, B, H, W, C, D, kh, kw, stride, padding,
                                          pool, M, m_active, relu, group_size):
    gen = torch.Generator().manual_seed(B * H * C + D)
    K = kh * kw * C
    gs = group_size or K
    x = torch.randn(B, H, W, C, generator=gen).to(card)
    tap = bck.pack_taps(_signs(gen, (M, K, D)), kh, kw, C).to(card)
    alpha = _alpha(gen, (M, K // gs, D)).to(card)
    bias = torch.randn(D, generator=gen).to(card)
    kw_ = dict(kh=kh, kw=kw, stride=stride, padding=padding, pool=pool,
               m_active=m_active, relu=relu)
    want = ref.fused_binary_conv_relu_pool_ref(x, tap, alpha, bias=bias, **kw_)
    before = ops.launch_counts()["binary_conv"]
    outs = [ops.binary_conv2d(x, tap, alpha, bias, plan=plan, **kw_) for plan in CONV_PLANS]
    torch.cuda.synchronize()
    assert ops.launch_counts()["binary_conv"] - before == len(CONV_PLANS)
    torch.testing.assert_close(outs[0], want, rtol=RTOL, atol=ATOL)
    for out in outs[1:]:
        assert torch.equal(outs[0], out)


@pytest.mark.parametrize("m_active", [1, 2, 3])
def test_binary_conv_kernel_folds_every_level_count(card, m_active):
    """M = 3 packed levels, each m_active 1..3, groups that span taps."""
    gen = torch.Generator().manual_seed(m_active)
    B, H, W, C, D, M = 3, 10, 10, 5, 43, 3
    K = 3 * 3 * C
    x = torch.randn(B, H, W, C, generator=gen).to(card)
    tap = bck.pack_taps(_signs(gen, (M, K, D)), 3, 3, C).to(card)
    alpha = _alpha(gen, (M, K // 15, D)).to(card)
    bias = torch.randn(D, generator=gen).to(card)
    kw_ = dict(kh=3, kw=3, stride=1, padding="SAME", pool=2, m_active=m_active)
    want = ref.fused_binary_conv_relu_pool_ref(x, tap, alpha, bias=bias, **kw_)
    outs = [ops.binary_conv2d(x, tap, alpha, bias, plan=plan, **kw_) for plan in CONV_PLANS]
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], want, rtol=RTOL, atol=ATOL)
    for out in outs[1:]:
        assert torch.equal(outs[0], out)


@pytest.mark.parametrize("P,C,D", [(3136 * 2 + 5, 512, 512), (7 * 7 * 3, 1024, 1000),
                                   (100, 12, 40)])
def test_pointwise_path_and_gather_path_give_the_same_bits(card, P, C, D):
    """A 1x1 layer goes through the kernel's 16-byte point-wise loads; the
    general gather path must give the same bits on it."""
    gen = torch.Generator().manual_seed(P + C)
    x = torch.randn(1, P, 1, C, generator=gen).to(card)
    tap = bck.pack_taps(_signs(gen, (2, C, D)), 1, 1, C).to(card)
    alpha = _alpha(gen, (2, 1, D)).to(card)
    bias = torch.randn(D, generator=gen).to(card)
    kw_ = dict(kh=1, kw=1, stride=1, pads=(0, 0), out_hw=(P, 1), pool=1, m_active=2,
               relu=True)
    for plan in ((128, 128), (64, 64)):
        dense = bck.launch(x, tap, alpha, bias, plan=plan, **kw_)
        gathered = bck.launch(x, tap, alpha, bias, plan=plan, gather=True, **kw_)
        torch.cuda.synchronize()
        assert torch.equal(dense, gathered)
    want = ref.fused_binary_conv_relu_pool_ref(x, tap, alpha, kh=1, kw=1, bias=bias)
    torch.testing.assert_close(dense, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,H,W,C,stride,M,m_active,relu", [
    (3, 112, 112, 32, 1, 2, None, True), (3, 14, 14, 512, 2, 2, 1, True),
    (2, 9, 9, 12, 1, 3, 2, False), (1, 7, 7, 1024, 1, 2, None, True),
    (2, 7, 7, 64, 2, 2, None, True),     # odd map at stride 2: pads (1, 1)
    (2, 15, 13, 128, 2, 2, 1, False),    # odd, non-square, stride 2
    (3, 9, 9, 5, 1, 2, None, True),      # C = 5: one channel per thread
    (2, 10, 10, 12, 2, 2, 2, True),      # C = 12: 4-channel groups across bytes
    (2, 1, 1, 32, 1, 2, None, True),     # 1x1 input
    (2, 1, 1, 5, 2, 2, None, False)])
def test_binary_dwconv_kernel_matches_plain(card, B, H, W, C, stride, M, m_active, relu):
    gen = torch.Generator().manual_seed(B * H + C)
    x = torch.randn(B, H, W, C, generator=gen).to(card)
    tap = bdw.pack_dw_taps(_signs(gen, (M, 9, C))).to(card)
    alpha = _alpha(gen, (M, C)).to(card)
    bias = torch.randn(C, generator=gen).to(card)
    kw_ = dict(kh=3, kw=3, stride=stride, m_active=m_active, relu=relu)
    want = ref.binary_dwconv_relu_ref(x, tap, alpha, bias=bias, **kw_)
    outs = [ops.binary_dwconv2d(x, tap, alpha, bias, plan=plan, **kw_)
            for plan in ((4, 32), (1, 256), (8, 64))]
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], want, rtol=RTOL, atol=ATOL)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_cnn_a_program_runs_its_kernels(card):
    gen = torch.Generator().manual_seed(0)
    program = deploy.compile(cnn.init_cnn_a(gen, device=card), "cnn_a",
                             QuantConfig(mode="binary"), (8, 48, 48, 3), device=card)
    x = torch.randn(8, 48, 48, 3, generator=gen).to(card)
    for m in (None, 1, [1, 2, 1, 2, 1]):
        ops.reset_launch_counts()
        picks = ops.plan_pick_count()
        got = deploy.execute(program, x, m)
        torch.cuda.synchronize()
        assert ops.launch_counts() == {"binary_conv": 2, "binary_dwconv": 0, "binary_matmul": 3}
        assert ops.plan_pick_count() == picks
        want = deploy.execute_reference(program, x, m)
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_launchers_refuse_bad_arguments(card):
    x = torch.zeros(1, 8, 8, 8, device=card)
    tap = torch.zeros(2, 9, 1, 16, dtype=torch.uint8, device=card)
    alpha = torch.ones(2, 1, 16, device=card)
    bias = torch.zeros(16, device=card)
    args = dict(kh=3, kw=3, stride=1, pads=(1, 1), out_hw=(8, 8), pool=1, m_active=2,
                relu=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bck.launch(x.cpu(), tap, alpha, bias, plan=(64, 64), **args)
    with pytest.raises(ValueError, match="float32"):
        bck.launch(x.double(), tap, alpha, bias, plan=(64, 64), **args)
    with pytest.raises(ValueError, match="plan"):
        bck.launch(x, tap, alpha, bias, plan=(6, 64), **args)
    with pytest.raises(ValueError, match="pool"):
        bck.launch(x, tap, alpha, bias, plan=(64, 64), **dict(args, pool=9, out_hw=(9, 9)))
    with pytest.raises(ValueError, match="m_active"):
        bck.launch(x, tap, alpha, bias, plan=(64, 64), **dict(args, m_active=3))
    with pytest.raises(ValueError, match="do not fit"):
        bck.launch(x, tap, alpha, bias, plan=(64, 64), **dict(args, out_hw=(10, 8)))
    five = torch.zeros(5, 9, 1, 16, dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="at most 4 levels"):
        bck.launch(x, five, torch.ones(5, 1, 16, device=card), bias, plan=(64, 64),
                   **dict(args, m_active=5))


def test_dwconv_launcher_takes_unpadded_input_and_refuses_what_it_was_not_built_for(card):
    x = torch.randn(2, 9, 9, 16, device=card)
    tap = torch.zeros(2, 9, 2, dtype=torch.uint8, device=card)
    alpha = torch.ones(2, 16, device=card)
    bias = torch.zeros(16, device=card)
    args = dict(kh=3, kw=3, stride=2, pads=(1, 1), out_hw=(5, 5), m_active=2, relu=False)
    want = ref.binary_dwconv_relu_ref(x, tap, alpha, kh=3, kw=3, stride=2, relu=False)
    torch.testing.assert_close(bdw.launch(x, tap, alpha, bias, plan=(2, 32), **args), want,
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="plan"):
        bdw.launch(x, tap, alpha, bias, plan=(3, 32), **args)
    with pytest.raises(ValueError, match="3x3"):
        bdw.launch(x, torch.zeros(2, 25, 2, dtype=torch.uint8, device=card), alpha, bias,
                   plan=(2, 32), **dict(args, kh=5, kw=5))
    with pytest.raises(ValueError, match="do not fit"):
        bdw.launch(x, tap, alpha, bias, plan=(2, 32), **dict(args, out_hw=(6, 5)))


def test_matmul_launcher_refuses_more_levels_than_it_was_built_for(card):
    x = torch.randn(4, 16, device=card)
    packed = torch.zeros(5, 2, 8, dtype=torch.uint8, device=card)
    alpha = torch.ones(5, 1, 8, device=card)
    assert bmk.launch(x, packed, alpha, K=16, group_size=16, m_active=4,
                      plan=(1, 32)).shape == (4, 8)
    with pytest.raises(ValueError, match="at most 4 levels"):
        bmk.launch(x, packed, alpha, K=16, group_size=16, m_active=5, plan=(1, 32))


def test_golden_checkpoint_and_service_on_the_card(card, tmp_path):
    """The serving path on the card: the golden record is made and replayed
    there, catches a flipped bit, survives a checkpoint round trip onto the
    card, and one served batch is bit-exact to ``execute``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.serve_cnn import CNNService
    from repro_torch.testing.faults import FaultInjector, FaultPlan

    gen = torch.Generator().manual_seed(0)
    quant = QuantConfig(mode="binary", M=2)
    shape = (8, 48, 48, 3)
    program = deploy.compile(cnn.init_cnn_a(gen, device=card), "cnn_a", quant, shape,
                             device=card)
    assert program.golden.device == "cuda" and deploy.self_test(program) == 3
    assert deploy.compute_golden(program) == program.golden
    bad = FaultInjector(FaultPlan(seed=1)).flip_bit_in_program(program)
    assert bad.instrs[0].B_tap_packed.device.type == "cuda"
    with pytest.raises(deploy.SelfTestFailure):
        deploy.self_test(bad)
    mgr = CheckpointManager(str(tmp_path))
    deploy.save_program(mgr, 1, program)
    like = deploy.abstract_program("cnn_a", quant, shape, device=card)
    loaded = deploy.load_program(mgr, 1, like)
    assert loaded.device.type == "cuda" and loaded.golden == program.golden
    for a, b in zip(program.instrs, loaded.instrs):
        for f in a.TREE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (a.name, f)
    assert deploy.self_test(loaded) == 3
    svc = CNNService(loaded, batch_size=8, selftest_every=1, checkpoint_manager=mgr,
                     restore_like=like)
    for _ in range(5):
        svc.submit(torch.randn(48, 48, 3, generator=gen).numpy())
    done = svc.step()
    assert [r.status for r in done] == ["done"] * 5 and svc.last_batch.device.type == "cuda"
    want = deploy.execute(program, svc.last_batch, svc.last_schedule).cpu()
    assert all(torch.equal(r.logits, want[r.batch_index]) for r in done)


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (2048, 16384), (16384, 2048)])
@pytest.mark.parametrize("T", [1, 8])
def test_binary_matmul_kernel_at_the_lm_shapes(card, T, K, N):
    """gemma-2b's linears (q/o, k/v under MQA, gate/up, down) at decode's
    row counts, m_active 1 and 2; K = 16384 cuts into chunks of 2048."""
    gen = torch.Generator().manual_seed(T + K + N)
    x = torch.randn(T, K, generator=gen).to(card)
    packed = bz.pack_bits(_signs(gen, (2, K, N))).to(card)
    alpha = (_alpha(gen, (2, 1, N)) / K ** 0.5).to(card)
    for m in (1, 2):
        want = ref.binary_matmul_ref(x, packed, alpha, K=K, group_size=K, m_active=m)
        outs = [ops.binary_matmul(x, packed, alpha, K=K, group_size=K, m_active=m, plan=plan)
                for plan in (None, (2, 64), (8, 32))]
        torch.cuda.synchronize()
        torch.testing.assert_close(outs[0], want, rtol=RTOL, atol=ATOL)
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_lm_server_on_the_card_matches_the_cpu(card):
    """A reduced gemma served on the card and on the CPU (plain versions):
    the same tokens, logits within rtol 2e-5 / atol 5e-5 (the JAX serving
    tests' tolerance), 2 layers x 7 matmul launches per decode group step."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import api, common as cm

    qc = QuantConfig(mode="binary", M=2, K_iters=2)
    cfg = reduced(get_config("gemma_2b")).replace(dtype="float32", quant=qc)
    host = api.binarize_model_params(
        cfg, api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    params = {"cpu": host, "cuda": cm.tree_map(lambda t: t.to(card), host)}
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy().astype("int32")
               for n in (5, 9, 3, 12)]
    served = {}
    for where, p in params.items():
        srv = Server(cfg, p, max_batch=3, max_len=32)
        reqs = [Request(prompt=pr, max_new_tokens=5, m_active=m)
                for pr, m in zip(prompts, (None, 1, (1, 2), None))]
        pending = list(reqs)
        while pending or any(s is not None for s in srv.slots):
            while pending and srv.admit(pending[0]):
                pending.pop(0)
            before, steps = ops.launch_counts()["binary_matmul"], srv.stats["decode_steps"]
            srv.step()
            if where == "cuda":
                torch.cuda.synchronize()
                assert ops.launch_counts()["binary_matmul"] - before == \
                    14 * (srv.stats["decode_steps"] - steps)
        served[where] = (reqs, srv.stats)
    assert served["cuda"][1] == served["cpu"][1]
    for a, b in zip(served["cuda"][0], served["cpu"][0]):
        assert a.out_tokens == b.out_tokens
        torch.testing.assert_close(torch.from_numpy(a.last_logits),
                                   torch.from_numpy(b.last_logits), rtol=2e-5, atol=5e-5)


@pytest.mark.parametrize("mode", ["dense", "fake_quant"])
def test_train_step_on_the_card_matches_the_cpu(card, mode):
    """One ``build_train_step`` step of a reduced gemma (fp32, TF32 off) on
    the card and on the CPU from the same state: loss, moments and params
    within rtol 1e-5 with a floor of 1e-5 x each leaf's largest entry (the
    CPU parity tests' tolerance; eps 1e-3 keeps Adam's first step from
    dividing a grad near 0 by itself)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.models import common as cm
    from repro_torch.optim import adamw

    cfg = reduced(get_config("gemma_2b")).replace(
        dtype="float32", quant=QuantConfig(mode=mode, M=2, K_iters=4))
    opt = adamw(1e-2, eps=1e-3)
    host = steps.init_train_state(cfg, opt, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 17), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    out = {}
    for where in ("cpu", "cuda"):
        state = cm.tree_map(lambda t: t.clone().to(where) if t.ndim else t.clone(), host)
        out[where] = steps.build_train_step(cfg, opt)(
            state, cm.tree_map(lambda t: t.to(where), batch))
    torch.cuda.synchronize()
    (sc, mc), (sg, mg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], rtol=1e-5, atol=0)
    for a, b in zip(cm.tree_leaves(sg), cm.tree_leaves(sc)):
        scale = float(b.abs().max()) if b.numel() else 0.0
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("seed", [0, 3, 6, 11, 62, 66])
def test_fuzz_network_on_the_card(card, seed):
    """The JAX package's pinned fuzz seeds, plus the first draws of a 1x1
    conv at stride 2 (62) and of pool 3 (66), compiled on the card: zero
    verifier ERRORs, ``execute`` torch.equal to the per-call kernel path
    (each layer with its own plan pick) and within rtol 1e-4 /
    atol 1e-4·max|logit| of the plain path, at m_active None and 1."""
    from repro_torch.analysis import verify_program
    from repro_torch.testing import fuzz

    net = fuzz.random_network(seed)
    qc = QuantConfig(mode="binary", M=net.M, K_iters=2)
    packed = cnn.spec_binarize(
        net.specs, net.init_params(torch.Generator().manual_seed(seed), device=card), qc)
    prog = deploy.compile(packed, net.specs, qc, net.input_shape, device=card, golden=False)
    assert not [f for f in verify_program(prog) if f.severity == "ERROR"]
    x = torch.randn((net.exec_batch,) + net.input_shape[1:],
                    generator=torch.Generator().manual_seed(seed + 99)).to(card)
    for m in (None, 1):
        before = ops.launch_counts()
        got = deploy.execute(prog, x, m)
        torch.cuda.synchronize()
        assert sum(ops.launch_counts().values()) - sum(before.values()) == len(prog)
        assert torch.equal(got, fuzz.kernel_forward(net.specs, packed, x, m))
        want = deploy.execute_reference(prog, x, m)
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def test_trace_lint_is_clean_on_the_card(card):
    """On the card ``execute`` runs no library conv or product, makes no plan
    pick and no float64, and repeated traffic launches one kernel per
    instruction per call: CNN-A and MobileNetV1-224 (abstract programs, whose
    uninitialised weights the lint never reads)."""
    from repro_torch.analysis import trace_lint

    quant = QuantConfig(mode="binary", M=2)
    for arch, shape in (("cnn_a", (4, 48, 48, 3)), ("mobilenet", (2, 224, 224, 3))):
        program = deploy.abstract_program(arch, quant, shape, device=card)
        scheds = (None, 1, [1 + i % 2 for i in range(len(program))])
        for m in scheds:
            assert trace_lint.lint_execute(program, m_active=m) == [], (arch, m)
        x = torch.zeros(shape, device=card)
        assert trace_lint.retrace_findings(program, x, schedules=scheds, repeats=2) == []


def test_executor_soak_on_the_card_has_flat_gauges(card):
    """60 steps of the executor scenario (CNN-A and a reduced MobileNet at
    batch 2): plan picks, loaded kernel libraries and live device bytes
    exactly flat after warmup."""
    from repro_torch.testing import scenarios
    from repro_torch.testing.soak import run_soak

    scen = scenarios.executor_scenario(device=card)
    assert "exec_live_bytes" in scen.gauges
    result = run_soak(scen.step, steps=60, name=scen.name, gauges=scen.gauges)
    assert scen.progress()["execute_calls"] == 60
    assert {n: result.gauge_growth(n) for n in scen.gauges} == {n: 0.0 for n in scen.gauges}
