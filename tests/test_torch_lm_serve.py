"""The port's LM ``Server`` against the JAX package's, on the CPU.

Reduced gemma (``configs.base.reduced``, dtype float32, ``QuantConfig(
mode="binary", M=2, K_iters=2)``) and reduced danube with its window cut to
4, the weights drawn and binarized by the JAX package and carried over by
``params_from_numpy``.  Each scenario is served once per package
(module-scoped fixture): the same requests, admitted as slots free.

Tolerances: ``out_tokens`` equal; ``last_logits`` rtol 2e-5 / atol 5e-5
(the JAX package's own bulk-vs-token-wise tolerance); ``stats`` and
``cache_sizes`` equal.
"""
import functools
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import binlinear as jbl
from repro.launch import serve as jserve
from repro.models import api as japi
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_numpy
from repro_torch.core import binlinear as tbl
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm

JQC = jbl.QuantConfig(mode="binary", M=2, K_iters=2)
TQC = tbl.QuantConfig(mode="binary", M=2, K_iters=2)


@functools.lru_cache(maxsize=None)
def _model(name: str):
    jc = jcb.reduced(jcb.get_config(name)).replace(dtype="float32", quant=JQC)
    tc = tcb.reduced(tcb.get_config(name)).replace(dtype="float32", quant=TQC)
    if jc.sliding_window:   # a 6-token prompt wraps a window of 4
        jc, tc = jc.replace(sliding_window=4), tc.replace(sliding_window=4)
    packed = japi.binarize_model_params(jc, japi.init_params(jc, jax.random.PRNGKey(0)))
    return jc, tc, packed, params_from_numpy(jax.tree.map(np.asarray, packed),
                                             device="cpu")


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


SCENARIOS = {  # name -> (arch, Server kwargs, prompt lengths, m_active per request)
    "bulk": ("gemma_2b", dict(max_batch=2, prefill="bulk", prefill_buckets=None),
             (6, 3, 9), (None,) * 3),
    "tokenwise": ("gemma_2b", dict(max_batch=2, prefill="tokenwise"), (6, 3, 9), (None,) * 3),
    "pow2": ("gemma_2b", dict(max_batch=2), (3, 5, 6, 7, 10), (None,) * 5),
    "buckets": ("gemma_2b", dict(max_batch=2, prefill_buckets=[8, 16]), (3, 6, 9, 20),
                (None,) * 4),
    "mixed_m": ("gemma_2b", dict(max_batch=3), (4, 7, 5, 9, 6),
                (None, 1, (1, 2), 2, (2, 2))),
    "swa_ring": ("h2o_danube_1_8b", dict(max_batch=2), (6, 3, 8), (None, 1, (2, 1))),
}


def _serve(mod, cfg, params, kw, lens, modes):
    srv = mod.Server(cfg, params, max_len=32, **kw)
    reqs = [mod.Request(prompt=p, max_new_tokens=4, m_active=m)
            for p, m in zip(_prompts(lens), modes)]
    pending = list(reqs)
    while pending or any(s is not None for s in srv.slots):
        while pending and srv.admit(pending[0]):
            pending.pop(0)
        srv.step()
    return reqs, dict(srv.stats), srv.cache_sizes()


@pytest.fixture(scope="module")
def served():
    out = {}
    for name, (arch, kw, lens, modes) in SCENARIOS.items():
        jc, tc, jp, tp = _model(arch)
        out[name] = (_serve(jserve, jc, jp, kw, lens, modes),
                     _serve(tserve, tc, tp, kw, lens, modes))
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_server_matches_the_reference(served, scenario):
    (jreqs, jstats, jsizes), (treqs, tstats, tsizes) = served[scenario]
    for j, t in zip(jreqs, treqs):
        assert t.done and t.out_tokens == j.out_tokens
        assert t.last_logits.dtype == np.float32 and t.last_logits.shape == (512,)
        np.testing.assert_allclose(t.last_logits, j.last_logits, rtol=2e-5, atol=5e-5)
    assert tstats == jstats
    assert tsizes == jsizes


def test_bulk_and_tokenwise_admission_agree(served):
    bulk, tokenwise = served["bulk"][1][0], served["tokenwise"][1][0]
    for b, t in zip(bulk, tokenwise):
        assert b.out_tokens == t.out_tokens
        np.testing.assert_allclose(b.last_logits, t.last_logits, rtol=2e-5, atol=5e-5)


def test_mixed_m_active_is_observable_and_isolated(served):
    """A request in the mixed batch gets the stream it gets served alone,
    and the level count changes the logits."""
    _, tc, _, tp = _model("gemma_2b")
    treqs = served["mixed_m"][1][0]
    for r in treqs[:3]:
        solo = tserve.Server(tc, tp, max_batch=3, max_len=32)
        again = tserve.Request(prompt=r.prompt.copy(), max_new_tokens=4, m_active=r.m_active)
        assert solo.admit(again)
        solo.run_until_done()
        assert again.out_tokens == r.out_tokens
        np.testing.assert_allclose(again.last_logits, r.last_logits, rtol=1e-5, atol=1e-5)
    full = tserve.Server(tc, tp, max_batch=1, max_len=32)
    one = tserve.Request(prompt=treqs[1].prompt.copy(), max_new_tokens=4)
    full.admit(one)
    full.run_until_done()
    assert not np.allclose(one.last_logits, treqs[1].last_logits)


@pytest.mark.parametrize("buckets", ["pow2", None, [8, 16], [4]])
def test_padded_len_and_norm_m_match(buckets):
    jc, tc, jp, tp = _model("gemma_2b")
    js = jserve.Server(jc, jp, max_batch=1, max_len=32, prefill_buckets=buckets)
    ts = tserve.Server(tc, tp, max_batch=1, max_len=32, prefill_buckets=buckets)
    assert [ts._padded_len(L) for L in range(0, 33)] == \
        [js._padded_len(L) for L in range(0, 33)]
    for m in (None, 0, 1, 2, 5, (1, 1), [2, 2], (1, 2), [3, 1], (2, 9)):
        assert ts._norm_m(m) == js._norm_m(m)
        tcfg, jcfg = ts._cfg_for(ts._norm_m(m)), js._cfg_for(js._norm_m(m))
        assert (tcfg.quant.m_active, tcfg.quant.m_schedule) == \
            (jcfg.quant.m_active, jcfg.quant.m_schedule)


def test_swa_prompts_stay_at_their_exact_length():
    jc, tc, jp, tp = _model("h2o_danube_1_8b")
    ts = tserve.Server(tc, tp, max_batch=1, max_len=32)
    assert not ts._pad_safe and ts._padded_len(5) == 5


def test_expired_requests_are_shed():
    jc, tc, jp, tp = _model("gemma_2b")
    for mod, cfg, params in ((jserve, jc, jp), (tserve, tc, tp)):
        srv = mod.Server(cfg, params, max_batch=1, max_len=32)
        late = mod.Request(prompt=np.arange(1, 5, dtype=np.int32),
                           deadline_s=time.monotonic() - 1.0)
        assert srv.admit(late) is False and srv.slots == [None]
        assert srv.stats["shed_count"] == 1 and srv.stats["bulk_prefills"] == 0


@pytest.mark.parametrize("kw", [dict(m_active=0), dict(m_active=[]), dict(m_active=(1, 0)),
                                dict(prompt=np.zeros(0, np.int32)),
                                dict(max_new_tokens=30)])
def test_malformed_requests_raise_at_admit(kw):
    jc, tc, jp, tp = _model("gemma_2b")
    args = {"prompt": np.arange(1, 5, dtype=np.int32), "max_new_tokens": 4, **kw}
    for mod, cfg, params in ((jserve, jc, jp), (tserve, tc, tp)):
        srv = mod.Server(cfg, params, max_batch=1, max_len=32)
        with pytest.raises(ValueError):
            srv.admit(mod.Request(**args))


def test_bad_server_options_raise():
    _, tc, _, tp = _model("gemma_2b")
    with pytest.raises(ValueError, match="prefill mode"):
        tserve.Server(tc, tp, prefill="eager")
    with pytest.raises(ValueError, match="prefill_buckets"):
        tserve.Server(tc, tp, prefill_buckets="fib")
    with pytest.raises(ValueError, match="bulk prefill"):
        tserve.Server(tc.replace(family="encdec"), tp, prefill="bulk")


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_other_families_raise(family):
    """A server of the family's reduced config starts (token-wise
    admission); under a family name no package knows it raises
    ``ValueError``."""
    name = {"encdec": "whisper_medium", "vlm": "internvl2_2b"}[family]
    cfg = tcb.reduced(tcb.get_config(name)).replace(dtype="float32", quant=TQC)
    params = tapi.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert not tserve.Server(cfg, params, max_batch=1, max_len=8)._bulk
    with pytest.raises(ValueError, match=family.upper()):
        tserve.Server(cfg.replace(family=family.upper()), params, max_batch=1, max_len=8)


def test_cache_and_staging_stay_on_the_params_device():
    _, tc, _, tp = _model("gemma_2b")
    srv = tserve.Server(tc, tp, max_batch=2, max_len=16)
    leaves = []
    tcm.tree_map(leaves.append, srv.cache)
    assert srv.device == torch.device("cpu") and all(t.device == srv.device for t in leaves)
    assert srv.cache_gauges()["decode_fns"]() == 0.0
