"""Serving example in the PyTorch/CUDA port: batched requests against a
binary-approximated LM.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

The port of ``examples/serve_lm.py``: binarizes a reduced model into packed
deployment form and serves a mixed batch of requests with continuous
batching, high-accuracy requests (all M levels) and high-throughput
requests (m_active=1) side by side in one ``Server``, off the same packed
buffers: the paper's §IV-D runtime switch, per request through
``Request.m_active``.  Admission uses bulk prefill (one forward pass and a
cache scatter per request, ``Server.stats``), and the per-slot state mask
lets the recurrent family (mamba2) serve mixed level counts too.  Every
binary linear runs the ``binary_matmul`` kernel on the card unless
``--device cpu`` is given (then its plain version), and fails without one.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import base as cb
from repro_torch.core.binlinear import QuantConfig
from repro_torch.launch.serve import Request, Server
from repro_torch.models import api


def serve_one(arch: str, label: str, dev: torch.device):
    cfg = cb.reduced(cb.get_config(arch)).replace(dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), device=dev)

    qc = QuantConfig(mode="binary", M=2, K_iters=8)
    bparams = api.binarize_model_params(cfg, params, qc=qc)

    prompts = [np.array([5, 9, 2], np.int32),
               np.array([17, 3, 3, 8], np.int32),
               np.array([1, 1, 2, 3, 5], np.int32)]

    srv = Server(cfg.replace(quant=qc), bparams, max_batch=4, max_len=64)
    modes = (None, 1, None)  # per-request §IV-D level count (None = all M)
    reqs = [Request(prompt=p, max_new_tokens=8, m_active=m) for p, m in zip(prompts, modes)]
    for r in reqs:
        assert srv.admit(r)
    srv.run_until_done()
    print(f"--- {label} ({arch}, family={cfg.family}) ---")
    for i, r in enumerate(reqs):
        mode = "high-throughput (m=1)" if r.m_active == 1 else "high-accuracy (all levels)"
        print(f"req{i} [{mode}] prompt={list(map(int, prompts[i]))} -> {r.out_tokens}")
    print(f"admission: {srv.stats['bulk_prefills']} bulk prefill passes, "
          f"{srv.stats['tokenwise_prefill_steps']} token-wise steps")
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"gemma_2b": serve_one("gemma_2b", "transformer, positional KV cache", dev)}
    # recurrent state + mixed m_active: needs the per-slot update mask
    out["mamba2_2_7b"] = serve_one("mamba2_2_7b", "ssm, masked recurrent state", dev)
    return out


if __name__ == "__main__":
    main()
