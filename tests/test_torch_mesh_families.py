"""The mesh LM on the families and head counts the sharded-LM tests do not
reach, on spawned CPU ranks (gloo), against the port's single-process
steps on the same params (``test_torch_lm_*.py`` hold those against the
JAX package).

One ``run_local`` spawn of world 4 (rank body in
``tests/_torch_mesh_family_ranks.py``, which imports no jax), the
references computed here while it runs:

  * reduced gemma widened to 2 heads of head_dim 512 (one kv head) on a
    1x4 mesh: the rules split wq's 1024 and wk/wv's 512 columns over the
    4-wide ``"model"`` axis, which divides neither head count, so the head
    view must take the projection whole (``attention.split_heads``);
  * reduced DeepSeek-V3 (MLA, one dense and one MoE layer, 4 experts top-2,
    the MTP head) on a 2x2 mesh, its experts split on ``"model"``, and
    reduced grok-1 cut to 2 experts on a 1x4 mesh, which the rules split by
    the experts' hidden dim instead (as grok's 8 experts on a 16-wide
    axis): routing and dispatch on plain tensors, the expert products on
    each rank's shards of the banks.  Capacity couples a request's
    tokens to its neighbours (ROADMAP, places that need care), so the mesh
    is held against single-process on the same batch, and the expert ids
    of every MoE call are compared explicitly (``torch.topk`` promises no
    tie order).

  * reduced mamba2 (SSM), zamba2 (hybrid: its shared attention block's
    cache beside the recurrent state), whisper (enc-dec: self and cross
    K/V, 24 frame embeddings) and internvl2 (VLM: 8 patch embeddings
    before the tokens), binary M=2 over the packed tree, on a 2x2 mesh:
    the recurrent state's masked write, the hybrid's shared-block cache
    and the enc-dec self-K/V write land in place on each rank's shard of
    the cache, and every binary linear runs the kernel wrapper on the
    rank's column shard (half the columns of the single-process call, the
    same K, its rows split on ``"data"`` where the single-process rows
    divide).

Each case runs one decode step (4 slots, a random cache) and one prefill
forward (4 x 8 tokens).  The SSM and hybrid cases' scans (``ssd_chunked``)
and recurrent updates (``recurrent_step``) must get plain tensors holding
the rank's part: half the rows (``"data"``) and half the heads
(``"model"``), B whole (one group).  Tolerance rtol 1e-4 / atol
1e-4·max|x| for the logits and the cache after the step, the sharded-LM
tests' (MKL's sums change order when a product's rows or columns are
split).

The same spawn then trains reduced mamba2 and zamba2 (fp32, fake-quant
M=2) two SGD steps on a 2x2 (data, model) mesh, the batch's rows split on
``"data"`` and the SSM heads on ``"model"``, against the single-process
steps.  Tolerances are ``test_torch_mesh_lm.py``'s: losses rtol 1e-4 and
each leaf's update within 1e-4 of its own L2 (its docstring says why per
leaf).
"""
import threading

import numpy as np
import pytest
import torch

import _torch_mesh_family_ranks as ranks
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_numpy
from repro_torch.core.binlinear import QuantConfig
from repro_torch.kernels import ops
from repro_torch.distributed import run_local
from repro_torch.models import api, moe
from repro_torch.models import common as tcm

SLOTS, MAX_LEN, PROMPT = 4, 16, 8
POS = np.array([3, 0, 7, 5], np.int32)
CASES = {"gemma_2x512": (lambda: tcb.reduced(tcb.get_config("gemma_2b")).replace(
             dtype="float32", n_heads=2, head_dim=512), 4),
         "deepseek": (lambda: tcb.reduced(tcb.get_config("deepseek_v3_671b")).replace(
             dtype="float32"), 2),
         "grok_2_experts": (lambda: tcb.reduced(tcb.get_config("grok_1_314b")).replace(
             dtype="float32", n_experts=2), 4)}
PACKED = {"mamba2": "mamba2_2_7b", "zamba2": "zamba2_7b", "whisper": "whisper_medium",
          "internvl2": "internvl2_2b"}
for _name, _arch in PACKED.items():
    CASES[_name] = (lambda arch=_arch: tcb.reduced(tcb.get_config(arch)).replace(
        dtype="float32", quant=QuantConfig(mode="binary", M=2, K_iters=2)), 2)
MOE = ("deepseek", "grok_2_experts")
TRAIN = ("mamba2", "zamba2")


def _train_cfg(name):
    return tcb.reduced(tcb.get_config(PACKED[name])).replace(
        dtype="float32", quant=QuantConfig(mode="fake_quant", M=2, K_iters=2))


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    cache = tcm.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                         api.cache_specs(cfg, SLOTS, MAX_LEN))
    batch = {"tokens": rng.integers(0, cfg.vocab, (SLOTS, 1)).astype(np.int32), "pos": POS,
             "cache": cache}
    prompt = {"tokens": rng.integers(0, cfg.vocab, (SLOTS, PROMPT)).astype(np.int32)}
    if cfg.family == "encdec":
        prompt["frame_embeds"] = rng.standard_normal(
            (SLOTS, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        prompt["patch_embeds"] = rng.standard_normal(
            (SLOTS, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch, prompt


def _single_process(cfg, batch_np, prompt_np) -> dict:
    ids, calls, real, real_mm = [], [], moe.route, ops.binary_matmul
    moe.route, ops.binary_matmul = ranks.recording_route(ids), ranks.recording_matmul(calls)
    try:
        params = ranks.params_of(cfg)
        with torch.no_grad():
            logits, cache = api.decode_step(cfg, params,
                                            params_from_numpy(batch_np, device="cpu"))
            decode_ids, decode_calls = list(ids), list(calls)
            ids.clear()
            calls.clear()
            prefill, _ = api.forward(cfg, params, params_from_numpy(prompt_np, device="cpu"))
    finally:
        moe.route, ops.binary_matmul = real, real_mm
    return {"decode": logits.numpy(), "prefill": prefill.numpy(),
            "cache": tcm.tree_map(lambda t: t.numpy(), cache), "decode_ids": decode_ids,
            "prefill_ids": list(ids), "decode_calls": decode_calls, "prefill_calls": list(calls)}


@pytest.fixture(scope="module")
def meshed():
    cases, refs = [], {}
    for i, (name, (make, n_model)) in enumerate(CASES.items()):
        cfg = make()
        batch, prompt = _inputs(cfg, i)
        cases.append((name, cfg, n_model, batch, prompt))
    train_cfgs = [(name, _train_cfg(name)) for name in TRAIN]
    out = {}

    def spawn():
        try:
            out["ranks"] = run_local(4, ranks.serve, cases, train_cfgs, device="cpu",
                                     timeout_s=300)
        except BaseException as e:  # noqa: BLE001 — raised below, in the test's thread
            out["ranks"] = e

    t = threading.Thread(target=spawn)
    t.start()
    try:
        for name, cfg, _, batch, prompt in cases:
            refs[name] = _single_process(cfg, batch, prompt)
        for name, cfg in train_cfgs:
            init = tcm.tree_map(lambda t: t.numpy().copy(), ranks.steps.init_train_state(
                cfg, ranks.optimizer(), device="cpu")["params"])
            state, losses = ranks.train(cfg, None)
            refs["train", name] = (losses, tcm.tree_map(lambda t: t.numpy(), state["params"]),
                                   init, cfg)
    finally:
        t.join()
    if isinstance(out["ranks"], BaseException):
        raise out["ranks"]
    return out["ranks"], refs


def _rel_close(got, want, rtol=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_logits_match_single_process(meshed, name, kind):
    per_rank, refs = meshed
    for r in per_rank:
        _rel_close(r[name][kind], refs[name][kind])


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("name", MOE)
def test_mesh_moe_routes_like_single_process(meshed, name, kind):
    """Every MoE call's expert ids: a decode routes every row on every rank
    (its dispatch is global); a prefill routes the rows of the rank's data
    coordinate."""
    per_rank, refs = meshed
    want = refs[name][f"{kind}_ids"]
    n_model = CASES[name][1]
    assert want
    for rank, r in enumerate(per_rank):
        got = r[name][f"{kind}_ids"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if kind == "prefill":
                rows = w.shape[0] // (len(per_rank) // n_model)
                w = w[rank // n_model * rows:(rank // n_model + 1) * rows]
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_cache_matches_single_process(meshed, name):
    """The cache after the decode step, written in place on each rank's
    shard (the KV rows, the latent cache, the recurrent and conv state,
    the hybrid's shared-block cache, the enc-dec self K/V)."""
    per_rank, refs = meshed
    want = tcm.tree_leaves(refs[name]["cache"])
    for r in per_rank:
        got = tcm.tree_leaves(r[name]["cache"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _rel_close(g, w)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("name", list(PACKED))
def test_binary_linears_run_on_column_shards(meshed, name, kind):
    """Each kernel call of the single-process step has its counterpart on
    every rank: the same K, half the columns (model 2), and half the rows
    (data 2) where the single-process rows split over the data axis."""
    per_rank, refs = meshed
    want = refs[name][f"{kind}_calls"]
    assert want
    for r in per_rank:
        got = r[name][f"{kind}_calls"]
        assert len(got) == len(want)
        for (x, b), (wx, wb) in zip(got, want):
            assert x[-1] == wx[-1] and b[:-1] == wb[:-1] and b[-1] * 2 == wb[-1]
            assert x[:-1] == ((wx[0] // 2,) + wx[1:-1] if wx[0] % 2 == 0 else wx[:-1])


@pytest.mark.parametrize("name", TRAIN)
def test_ssm_scan_and_update_run_on_each_ranks_part(meshed, name):
    per_rank, _ = meshed
    cfg = CASES[name][0]()
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    n = cfg.ssm_state
    want = {"ssd": ((SLOTS // 2, PROMPT, H // 2, cfg.ssm_head_dim), (SLOTS // 2, PROMPT, 1, n)),
            "recurrent": ((SLOTS // 2, H // 2, cfg.ssm_head_dim), (SLOTS // 2, H // 2, n))}
    for r in per_rank:
        scans = r[name]["scans"]
        assert [s[0] for s in scans] == ["recurrent"] * cfg.n_layers + ["ssd"] * cfg.n_layers
        assert all(not dt and (x, b) == want[k] for k, dt, x, b in scans), scans[:2]


@pytest.mark.parametrize("name", TRAIN)
def test_mesh_train_step_matches_single_process(meshed, name):
    per_rank, refs = meshed
    losses, params, init, _ = refs["train", name]
    for r in per_rank:
        np.testing.assert_allclose(r["train", name]["losses"], losses, rtol=1e-4)
        for i, (g, w, p) in enumerate(zip(*(tcm.tree_leaves(t) for t in (
                r["train", name]["params"], params, init)))):
            err = float(np.linalg.norm(g.astype(np.float64) - w))
            upd = float(np.linalg.norm(w.astype(np.float64) - p))
            assert err <= 1e-4 * upd, (i, w.shape, err, upd)


@pytest.mark.parametrize("name", TRAIN)
def test_train_scan_runs_on_each_ranks_rows_and_heads(meshed, name):
    """Every ``ssd_chunked`` call of the mesh train steps gets plain
    tensors: the rank's half of the batch and of the heads, B whole (one
    group)."""
    per_rank, refs = meshed
    cfg = refs["train", name][3]
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    want = ("ssd", False, (ranks.BATCH // 2, ranks.SEQ, H // 2, cfg.ssm_head_dim),
            (ranks.BATCH // 2, ranks.SEQ, 1, cfg.ssm_state))
    for r in per_rank:
        calls = r["train", name]["scans"]
        assert len(calls) >= ranks.TRAIN_STEPS * cfg.n_layers
        assert all(c == want for c in calls), calls[:3]
