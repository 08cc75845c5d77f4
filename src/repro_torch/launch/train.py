"""End-to-end training launcher on one device (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b --reduced \\
        --steps 50 --checkpoint-dir checkpoints/gemma_reduced

Trains a dense config on the synthetic token pipeline through
``launch/steps.py`` and ``runtime/trainer.py``: AdamW on a warmup-cosine
schedule, checkpoints every ``--checkpoint-every`` steps and at the last,
resume from the latest checkpoint in ``--checkpoint-dir``, optional
fake-quant (QAT) and binary gradient compression.  Runs on the card unless
``--device cpu`` is given, and fails without one.  No mesh: sharded
training waits for ``distributed/`` (ROADMAP).
"""
from __future__ import annotations

import argparse
import logging

from repro_torch import resolve_device
from repro_torch.configs import base as cb
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.launch import steps as steps_mod
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
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

    dev = resolve_device(args.device)
    cfg = cb.get_config(args.arch)
    if args.reduced:
        cfg = cb.reduced(cfg)
    if args.quant_mode != "dense":
        cfg = cfg.replace(quant=cfg.quant.replace(mode=args.quant_mode, M=args.quant_M))

    optimizer = adamw(warmup_cosine(args.lr, 10, args.steps))
    state = steps_mod.init_train_state(cfg, optimizer, device=dev)
    if args.grad_compress_M:
        from repro_torch.core import compress as gcomp

        state["grad_comp"] = gcomp.init_state(state["params"])
    step_fn = steps_mod.build_train_step(cfg, optimizer,
                                         grad_compress_M=args.grad_compress_M)
    data = SyntheticTokens(cfg.vocab, args.seq, args.batch, device=dev)
    trainer = Trainer(step_fn, state, data, TrainerConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir))
    trainer.maybe_resume()
    report = trainer.run()
    final = f"{report.losses[-1]:.4f}" if report.losses else "none"
    print(f"done: {report.steps_run} steps, final loss {final}, "
          f"resumed_from={report.resumed_from}, "
          f"stragglers={len(report.straggler_events)}, nan_skips={report.nan_skips}")


if __name__ == "__main__":
    main()
