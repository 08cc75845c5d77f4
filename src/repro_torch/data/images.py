"""Synthetic GTSRB-like image pipeline for the paper's CNN-A experiments
(port of ``repro/data/images.py``).

43 classes of procedurally generated "traffic signs": each class is a fixed
random template (smoothed noise field per channel) plus per-sample
translation, brightness jitter and noise.  The arrays are the JAX package's,
made with the same numpy generator from the same seed; only the last step
differs: they become tensors on the pipeline's device (images float32 NHWC,
labels int64, PyTorch's index type).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


class SyntheticGTSRB:
    def __init__(self, *, n_classes: int = 43, size: int = 48, seed: int = 0,
                 device="cuda"):
        self.n_classes = n_classes
        self.size = size
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        # class templates: smooth random fields, distinct per class
        self.templates = rng.normal(0, 1, (n_classes, size, size, 3)).astype(np.float32)
        for c in range(n_classes):
            for ch in range(3):
                t = self.templates[c, :, :, ch]
                # cheap smoothing: separable box blur x3
                for _ in range(3):
                    t = (np.roll(t, 1, 0) + t + np.roll(t, -1, 0)) / 3
                    t = (np.roll(t, 1, 1) + t + np.roll(t, -1, 1)) / 3
                self.templates[c, :, :, ch] = t
        self.templates /= np.abs(self.templates).max(axis=(1, 2, 3), keepdims=True)

    def batch(self, batch_size: int, *, rng: np.random.Generator):
        """(images [B, size, size, 3] float32, labels [B] int64) on the
        pipeline's device, drawn from ``rng``."""
        labels = rng.integers(0, self.n_classes, batch_size)
        imgs = self.templates[labels].copy()
        # jitter: shift, brightness, noise (tuned so a trained fp32 CNN-A
        # sits around ~90% — binarization visibly hurts, retraining recovers)
        for i in range(batch_size):
            dx, dy = rng.integers(-5, 6, 2)
            imgs[i] = np.roll(imgs[i], (dx, dy), axis=(0, 1))
        imgs *= rng.uniform(0.6, 1.4, (batch_size, 1, 1, 1)).astype(np.float32)
        imgs += rng.normal(0, 0.45, imgs.shape).astype(np.float32)
        return (torch.from_numpy(imgs).to(self.device),
                torch.from_numpy(labels.astype(np.int64)).to(self.device))

    def eval_set(self, n: int, seed: int = 1234):
        return self.batch(n, rng=np.random.default_rng(seed))
