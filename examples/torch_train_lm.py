"""End-to-end LM training driver in the PyTorch/CUDA port (~100M-class
model, a few hundred steps).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_train_lm.py \\
        --steps 200 --grad-compress-M 2                   # a 4x1 mesh

The port of ``examples/train_lm.py``: trains a scaled-down qwen3-family
decoder on the synthetic token pipeline with the production stack: the
train step of ``launch/steps.py``, checkpointing, the straggler watchdog,
optional QAT (``--quant fake_quant``) and binary gradient compression
(``--grad-compress-M 2``).  Started by a launcher that sets ``WORLD_SIZE``
> 1, every rank trains on the ``(world, 1)`` (data, model) mesh
(``launch/train.launcher_mesh``): params, moments and the compression's
error state sharded by the rules, each rank on its own card (NCCL).  Runs
on the card unless ``--device cpu`` is given (gloo between CPU ranks), and
fails without one.  ``--reduced`` trains the reduced qwen3 instead.
"""
import argparse
import logging

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import base as cb
from repro_torch.core import compress as gcomp
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.train import launcher_mesh
from repro_torch.models import api
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--quant", default="dense", choices=["dense", "fake_quant"])
    ap.add_argument("--grad-compress-M", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="checkpoints/torch_train_lm")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh, dev, owns_group = launcher_mesh(resolve_device(args.device))
    rank = dist.get_rank() if mesh is not None else 0

    # ~100M-class config: qwen3 family, 8 layers, d=512
    cfg = cb.get_config("qwen3_14b").replace(
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab=8192, remat=False)
    if args.reduced:
        cfg = cb.reduced(cb.get_config("qwen3_14b"))
    if args.quant != "dense":
        cfg = cfg.replace(quant=cfg.quant.replace(mode=args.quant, M=2, K_iters=4))
    n_params = sum(t.numel() for t in tree_leaves(api.param_shapes(cfg)))
    if rank == 0:
        print(f"model: {n_params / 1e6:.1f}M params, quant={args.quant}, "
              f"mesh={'none' if mesh is None else tuple(mesh.shape)}")

    opt = adamw(warmup_cosine(3e-4, 20, args.steps))
    state = steps_mod.init_train_state(cfg, opt, device=dev, mesh=mesh)
    if args.grad_compress_M:
        state["grad_comp"] = gcomp.init_state(state["params"])
    step_fn = steps_mod.build_train_step(cfg, opt, grad_compress_M=args.grad_compress_M,
                                         mesh=mesh)
    shardings = None if mesh is None else steps_mod.train_state_shardings(
        cfg, mesh, opt, grad_compress_M=args.grad_compress_M)
    data = SyntheticTokens(cfg.vocab, args.seq, args.batch, device=dev)
    trainer = Trainer(step_fn, state, data, TrainerConfig(
        total_steps=args.steps, checkpoint_every=max(args.steps // 4, 10),
        checkpoint_dir=args.checkpoint_dir, log_every=10), state_shardings=shardings)
    trainer.maybe_resume()
    report = trainer.run()
    if owns_group:
        dist.destroy_process_group()
    n = min(10, len(report.losses))
    if rank == 0 and n:
        print(f"\nfirst-{n} mean loss {sum(report.losses[:n]) / n:.4f} -> "
              f"last-{n} mean loss {sum(report.losses[-n:]) / n:.4f}")
        print(f"stragglers={len(report.straggler_events)} "
              f"nan_skips={report.nan_skips} resumed={report.resumed_from}")
    return report


if __name__ == "__main__":
    main()
