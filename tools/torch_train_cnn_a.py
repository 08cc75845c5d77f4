#!/usr/bin/env python3
"""The paper's Table II pipeline on CNN-A, in the PyTorch/CUDA port.

    python3 tools/torch_train_cnn_a.py [--steps 300] [--M 2] [--device cuda]

Port of ``examples/train_cnn_a.py`` on synthetic GTSRB (48²x3, 43 classes):

  1. train the fp32 baseline (AdamW 1e-3, batch 64);
  2. binary-approximate it with Algorithm 2 (M levels, K_iters 25) and
     measure the accuracy without retraining;
  3. retrain with the straight-through estimator (paper §V-B1: AdamW 1e-4)
     for half the steps (at least 50);
  4. pack the retrained weights (``spec_binarize``), compile them
     (``deploy.compile``, golden record included) and run the eval set
     through ``deploy.execute``: on the card that is the ``binary_conv`` and
     ``binary_matmul`` kernels, whose launches in that call are counted;
  5. report the four accuracies and the weight compression (the packed
     tree against fp32, and paper Eq. 6 per layer).

Runs on the card unless ``--device cpu`` is given (then ``execute`` runs
the kernels' plain versions), and fails without one.  ``chip_smoke.py``
phase 8a calls :func:`table2`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
from repro_torch import deploy, resolve_device  # noqa: E402
from repro_torch.core import binarize as bz  # noqa: E402
from repro_torch.core.binlinear import QuantConfig  # noqa: E402
from repro_torch.data.images import SyntheticGTSRB  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

DENSE = QuantConfig(mode="dense")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def logits_of(params, x, quant=DENSE) -> torch.Tensor:
    return cnn.cnn_a_forward(params, x, quant)


def accuracy(logits: torch.Tensor, y: torch.Tensor) -> float:
    return float((torch.argmax(logits, -1) == y).to(torch.float32).mean())


def train(params, ds, *, steps: int, lr: float, quant: QuantConfig, batch: int = 64,
          seed: int = 0, log_every: int = 50) -> tuple[list, list]:
    """AdamW on cross-entropy, params updated in place; returns the loss and
    the wall time (host clock, the loss read included) of every step."""
    opt = adamw(lr)
    state = opt.init(params)
    rng = np.random.default_rng(seed)

    def loss(p, x, y):
        logp = torch.log_softmax(cnn.cnn_a_forward(p, x, quant), dim=-1)
        nll = -torch.mean(torch.gather(logp, 1, y[:, None]))
        return nll, {"loss": nll}

    losses, seconds = [], []
    for i in range(steps):
        x, y = ds.batch(batch, rng=rng)
        t0 = time.perf_counter()
        grads, metrics = loss_and_grads(loss, params, x, y)
        opt.update(grads, state, params, i)
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
        if i % log_every == 0:
            print(f"  step {i:4d} loss {losses[-1]:.4f}")
    return losses, seconds


def _bits(tree) -> int:
    return sum(t.numel() * t.element_size() * 8 for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def table2(*, steps: int = 300, M: int = 2, eval_n: int = 512, batch: int = 64,
           device="cuda") -> dict:
    """Steps 1-5 above; returns the accuracies, losses, step times, the
    retrained fp tree, the compiled program, and the fake-quant and deployed
    logits of the eval set."""
    dev = resolve_device(device)
    ds = SyntheticGTSRB(n_classes=cnn.CNN_A_CLASSES, seed=0, device=dev)
    x_eval, y_eval = ds.eval_set(eval_n)

    print("1) training the fp32 CNN-A baseline...")
    params = cnn.init_cnn_a(torch.Generator().manual_seed(0), device=dev)
    fp_losses, fp_s = train(params, ds, steps=steps, lr=1e-3, quant=DENSE, batch=batch)
    acc_fp = accuracy(logits_of(params, x_eval), y_eval)
    print(f"   baseline accuracy: {acc_fp:.4f}")

    qc = QuantConfig(mode="fake_quant", M=M, algorithm=2, K_iters=25)
    acc_bin = accuracy(logits_of(params, x_eval, qc), y_eval)
    print(f"2) binary-approximated (Algorithm 2, M={M}) without retraining: {acc_bin:.4f}")

    print("3) retraining with the straight-through estimator (paper §V-B1, AdamW 1e-4)...")
    params_rt = tree_map(torch.clone, params)
    rt_losses, rt_s = train(params_rt, ds, steps=max(steps // 2, 50), lr=1e-4, quant=qc,
                            batch=batch, seed=1)
    lg_fq = logits_of(params_rt, x_eval, qc)
    acc_rt = accuracy(lg_fq, y_eval)
    print(f"   retrained accuracy: {acc_rt:.4f}  (fp baseline {acc_fp:.4f})")

    print("4) packing, compiling and executing the deployment program...")
    t0 = time.perf_counter()
    binary = QuantConfig(mode="binary", M=M, K_iters=25)
    packed = cnn.binarize_cnn_a(params_rt, binary)
    program = deploy.compile(packed, "cnn_a", binary, (batch, *cnn.CNN_A_INPUT), device=dev)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    lg_dep = deploy.execute(program, x_eval)
    _sync(dev)
    launches = ops.launch_counts()
    acc_dep = accuracy(lg_dep, y_eval)
    print(f"   deployed accuracy: {acc_dep:.4f} (compile {compile_s:.1f} s); within 0.02 of "
          f"fake-quant: {abs(acc_dep - acc_rt) <= 0.02}; kernel launches {launches}")

    compression = _bits(params) / _bits(packed)
    eq6 = {s.name: bz.compression_factor(int(np.prod(params[s.name]["w"].shape[:-1])), M)
           for s in cnn.CNN_A_SPECS}
    print(f"5) weight compression of the packed tree: {compression:.2f}x (Eq. 6 per layer "
          f"{json.dumps({k: round(v, 2) for k, v in eq6.items()})}, asymptote {32 / M:.1f}x)")
    return {"acc_fp": acc_fp, "acc_bin": acc_bin, "acc_rt": acc_rt, "acc_deploy": acc_dep,
            "compression": compression, "eq6": eq6, "fp_losses": fp_losses,
            "rt_losses": rt_losses, "fp_step_ms": 1e3 * statistics.median(fp_s),
            "rt_step_ms": 1e3 * statistics.median(rt_s), "compile_s": compile_s,
            "launches": launches,
            "params_rt": params_rt, "program": program, "x_eval": x_eval,
            "logits_fake_quant": lg_fq, "logits_deploy": lg_dep}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--M", type=int, default=2)
    ap.add_argument("--eval", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = table2(steps=args.steps, M=args.M, eval_n=args.eval, device=args.device)
    print(json.dumps({k: out[k] for k in ("acc_fp", "acc_bin", "acc_rt", "acc_deploy",
                                          "compression", "fp_step_ms", "rt_step_ms")}))


if __name__ == "__main__":
    main()
