"""End-to-end driver in the PyTorch/CUDA port: the paper's CNN-A workflow
on synthetic GTSRB.

    PYTHONPATH=src python examples/torch_train_cnn_a.py [--steps 300] [--device cpu]

The port of ``examples/train_cnn_a.py``, the Table II pipeline: train the
fp32 baseline -> binary-approximate it (Algorithm 2) -> measure the
accuracy drop -> retrain with the STE at a low lr -> convert to packed
deployment form -> compile it and check the compiled program (the
``binary_conv`` and ``binary_matmul`` kernels, ReLU and max-pool fused)
against the layer-by-layer packed forward (the kernels' plain versions).  Runs on the card unless
``--device cpu`` is given (then the kernels' plain versions), and fails
without one.  ``tools/torch_train_cnn_a.py`` runs the same table with its
times and launch counts.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import deploy as dpl
from repro_torch import resolve_device
from repro_torch.core.binlinear import QuantConfig
from repro_torch.data.images import SyntheticGTSRB
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import cnn
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw


@torch.no_grad()
def accuracy(params, x, y, quant=QuantConfig(mode="dense")):
    """The accuracy of an fp tree (dense or fake-quant) or, with a binary
    ``quant``, of the packed tree layer by layer (the kernels' plain
    versions, ``cnn.spec_forward``)."""
    if quant.mode == "binary":
        logits = cnn.spec_forward(cnn.CNN_A_SPECS, params, x, quant)
    else:
        logits = cnn.cnn_a_forward(params, x, quant)
    return float((torch.argmax(logits, -1) == y).to(torch.float32).mean())


def train(params, ds, *, steps, lr, quant, batch=64, seed=0, log_every=50):
    """AdamW on cross-entropy; ``params`` are updated in place."""
    opt = adamw(lr)
    state = opt.init(params)
    rng = np.random.default_rng(seed)

    def loss(p, x, y):
        logp = torch.log_softmax(cnn.cnn_a_forward(p, x, quant), dim=-1)
        nll = -torch.mean(torch.gather(logp, 1, y[:, None]))
        return nll, {"loss": nll}

    for i in range(steps):
        x, y = ds.batch(batch, rng=rng)
        grads, metrics = loss_and_grads(loss, params, x, y)
        opt.update(grads, state, params, i)
        if i % log_every == 0:
            print(f"  step {i:4d} loss {float(metrics['loss']):.4f}")
    return params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--retrain-steps", type=int, default=None,
                    help="STE retraining steps (default: half of --steps, at least 50)")
    ap.add_argument("--M", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = SyntheticGTSRB(n_classes=cnn.CNN_A_CLASSES, seed=0, device=dev)
    x_eval, y_eval = ds.eval_set(args.eval)

    print("1) training fp32 CNN-A baseline...")
    params = cnn.init_cnn_a(torch.Generator().manual_seed(0), device=dev)
    train(params, ds, steps=args.steps, lr=1e-3, quant=QuantConfig(mode="dense"),
          batch=args.batch)
    acc_fp = accuracy(params, x_eval, y_eval)
    print(f"   baseline accuracy: {acc_fp:.4f}")

    qc = QuantConfig(mode="fake_quant", M=args.M, algorithm=2, K_iters=25)
    acc_bin = accuracy(params, x_eval, y_eval, qc)
    print(f"2) binary-approximated (Alg-2, M={args.M}) without retraining: {acc_bin:.4f}")

    print("3) retraining with straight-through estimator (paper §V-B1, Adam 1e-4)...")
    retrain = args.retrain_steps if args.retrain_steps is not None else max(args.steps // 2, 50)
    params_rt = train(tree_map(torch.clone, params), ds, steps=retrain, lr=1e-4, quant=qc,
                      batch=args.batch, seed=1)
    acc_rt = accuracy(params_rt, x_eval, y_eval, qc)
    print(f"   retrained accuracy: {acc_rt:.4f}  (fp baseline {acc_fp:.4f})")

    print("4) converting to packed deployment form...")
    t0 = time.time()
    binary = QuantConfig(mode="binary", M=args.M, K_iters=25)
    packed = cnn.binarize_cnn_a(params_rt, binary)
    acc_deploy = accuracy(packed, x_eval, y_eval, binary)
    print(f"   packed-binary accuracy: {acc_deploy:.4f} ({time.time() - t0:.1f}s) — "
          f"matches fake-quant: {abs(acc_deploy - acc_rt) < 0.02}")

    # compile the packed tree into a BinArrayProgram (paper §IV: tile plans
    # frozen offline, zero per-call scheduling) and spot-check the fused
    # kernels against the layer-by-layer packed forward
    n = min(16, args.eval)
    program = dpl.compile(packed, "cnn_a", binary, input_shape=(n, *cnn.CNN_A_INPUT),
                          device=dev)
    with torch.no_grad():
        lg_ref = cnn.spec_forward(cnn.CNN_A_SPECS, packed, x_eval[:n], binary)
    lg_fused = dpl.execute(program, x_eval[:n])
    drift = float((lg_fused - lg_ref).abs().max())
    print(f"   compiled program (fused kernels) == layer-by-layer path: "
          f"max |Δlogit| = {drift:.2e}")

    def bits(tree):
        return sum(t.numel() * t.element_size() * 8 for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))
    # the packed tree holds one packing per conv (per tap), as a shipped
    # artifact does
    print(f"5) weight compression: {bits(params) / bits(packed):.1f}x "
          f"(Eq. 6 asymptote {32 / args.M:.1f}x)")
    return {"acc_fp": acc_fp, "acc_bin": acc_bin, "acc_rt": acc_rt, "acc_deploy": acc_deploy,
            "drift": drift}


if __name__ == "__main__":
    main()
