"""End-to-end training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b --reduced \\
        --steps 50 --checkpoint-dir checkpoints/gemma_reduced
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch gemma_2b --reduced --grad-compress-M 2     # a 4x1 mesh

Trains a dense config on the synthetic token pipeline through
``launch/steps.py`` and ``runtime/trainer.py``: AdamW on a warmup-cosine
schedule, checkpoints every ``--checkpoint-every`` steps and at the last,
resume from the latest checkpoint in ``--checkpoint-dir``, optional
fake-quant (QAT) and binary gradient compression.  Runs on the card unless
``--device cpu`` is given, and fails without one.  Started by a launcher
that sets ``WORLD_SIZE`` > 1 (``torchrun``), every rank joins one process
group (NCCL with one card per rank, gloo on the CPU; a group the caller
already started is used as it is) and trains on ``make_host_mesh()``, a
``(world, 1)`` (data, model) mesh, as the JAX launcher does: state sharded
by the rules (the compression's error state on the params' placements),
resume onto the mesh through ``Trainer(state_shardings=)``.  Returns the
Trainer's report.
"""
from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import base as cb
from repro_torch.core import compress as gcomp
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def launcher_mesh(dev: torch.device):
    """Under a launcher that sets ``WORLD_SIZE`` > 1 (``torchrun``): this
    rank's device (``LOCAL_RANK``'s card when ``dev`` is a card), the
    process group joined (NCCL on cards, gloo on the CPU; one the caller
    started is used as it is) and ``make_host_mesh()`` over it.  Returns
    ``(mesh, dev, owns_group)``; ``(None, dev, False)`` in one process."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, dev, False
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    owns_group = not dist.is_initialized()
    if owns_group:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_host_mesh(device=dev), dev, owns_group


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--quant-mode", default="dense", choices=["dense", "fake_quant"])
    ap.add_argument("--quant-M", type=int, default=2)
    ap.add_argument("--grad-compress-M", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh, dev, owns_group = launcher_mesh(resolve_device(args.device))
    cfg = cb.get_config(args.arch)
    if args.reduced:
        cfg = cb.reduced(cfg)
    if args.quant_mode != "dense":
        cfg = cfg.replace(quant=cfg.quant.replace(mode=args.quant_mode, M=args.quant_M))

    optimizer = adamw(warmup_cosine(args.lr, 10, args.steps))
    state = steps_mod.init_train_state(cfg, optimizer, device=dev, mesh=mesh)
    if args.grad_compress_M:
        state["grad_comp"] = gcomp.init_state(state["params"])
    step_fn = steps_mod.build_train_step(cfg, optimizer,
                                         grad_compress_M=args.grad_compress_M, mesh=mesh)
    data = SyntheticTokens(cfg.vocab, args.seq, args.batch, device=dev)
    shardings = (None if mesh is None else steps_mod.train_state_shardings(
        cfg, mesh, optimizer, grad_compress_M=args.grad_compress_M))
    trainer = Trainer(step_fn, state, data, TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir), state_shardings=shardings)
    trainer.maybe_resume()
    report = trainer.run()
    rank = dist.get_rank() if mesh is not None else 0
    if owns_group:
        dist.destroy_process_group()
    if rank:
        return report
    final = f"{report.losses[-1]:.4f}" if report.losses else "none"
    print(f"done: {report.steps_run} steps, final loss {final}, "
          f"resumed_from={report.resumed_from}, "
          f"stragglers={len(report.straggler_events)}, nan_skips={report.nan_skips}")
    return report


if __name__ == "__main__":
    main()
