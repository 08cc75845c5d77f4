"""The dry run's count of the Mamba2 scan on each rank's part of the work
over a mesh (``models/ssm.py``'s ``_Part``).

The dry run (``launch/dryrun.py``'s fake process group, ``meta`` tensors)
counts one rank's train step of reduced mamba2 and zamba2 on a
(pod, data, model) = 2x2x2 mesh: every ``ssd_chunked`` call of the step
gets the rank's 2 of 8 batch rows and half of the heads, so its FLOPs
are the single-device scan's divided by the ranks that split them: the
per-head products by all 8, the C·B product (one group, shared by the
heads) by the 4 ranks that split the batch.
``test_torch_mesh_families.py`` trains both on spawned CPU ranks against
the single-process steps and serves them there.
"""
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import base as tcb
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.models import ssm as ssm_mod

ARCHS = ("mamba2_2_7b", "zamba2_7b")


def _ssd_flops(xh, dt, A, Bm, Cm, D, chunk) -> float:
    with ca.CostCounter() as c:
        ssm_mod.ssd_chunked(xh, dt, A, Bm, Cm, D, chunk)
    return c.total_flops()


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_train_cell_splits_the_scan_over_the_ranks(arch, monkeypatch):
    monkeypatch.setitem(tcb.SHAPES, "train_4k", dict(seq_len=16, global_batch=8, kind="train"))
    cfg = tcb.reduced(tcb.get_config(arch))
    B, L, n, hd = 8, 16, cfg.ssm_state, cfg.ssm_head_dim
    H = cfg.ssm_expand * cfg.d_model // hd
    chunk = min(cfg.ssm_chunk, L)
    single = _ssd_flops(_meta(B, L, H, hd), _meta(B, L, H), _meta(H), _meta(B, L, 1, n),
                        _meta(B, L, 1, n), _meta(H), chunk)
    cb = 2.0 * B * L * chunk * n       # C·B: b·c·g·l·s·n MACs, one group
    want = ((B // 4, L, H // 2, hd), (single - cb) / 8 + cb / 4)
    per_call, real = [], ssm_mod.ssd_chunked

    def counted(*args, **kw):
        with ca.CostCounter() as c:
            out = real(*args, **kw)
        per_call.append((tuple(args[0].shape), c.total_flops()))
        return out

    monkeypatch.setattr(ssm_mod, "ssd_chunked", counted)
    with dryrun.fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                          mesh_dim_names=("pod", "data", "model"))
        compiled = dryrun._lower_for(cfg, mesh, "train_4k",
                                     tcb.input_specs(cfg, "train_4k")).compile()
    assert compiled.flops_by_class and compiled.cost_analysis()["bytes accessed"] > 0
    assert len(per_call) >= cfg.n_layers
    assert set(per_call) == {want}
