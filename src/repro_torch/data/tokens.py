"""Deterministic synthetic token pipeline, checkpointable (port of
``repro/data/tokens.py``).

A structured synthetic language (Zipfian unigrams + repeated bigrams as a
copy/induction signal) so models have learnable signal.  The state is a
(seed, step) pair stored in checkpoints, so a restarted job resumes mid-run
with identical batches.  Batches are the JAX package's arrays, made with the
same numpy generator, as int64 tensors on the pipeline's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class TokenPipelineState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticTokens:
    """Iterator of {tokens, labels} batches with next-token labels."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1, device="cuda"):
        if global_batch % n_hosts:
            raise ValueError(f"global_batch {global_batch} must divide over {n_hosts} hosts")
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.device = resolve_device(device)
        self.state = TokenPipelineState(seed=seed, step=0)
        # Zipfian unigram distribution (heavy head like natural text)
        p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
        self._probs = p / p.sum()

    def _rng(self):
        # distinct stream per (seed, step, host): deterministic resume
        return np.random.default_rng(
            (self.state.seed * 1_000_003 + self.state.step) * 65_537 + self.host_id)

    def next_batch(self):
        rng = self._rng()
        B, S = self.local_batch, self.seq_len
        toks = rng.choice(self.vocab, size=(B, S + 1), p=self._probs)
        # induction patterns: random repeated bigrams (copy task signal)
        for b in range(B):
            for _ in range(max(1, S // 64)):
                i = rng.integers(0, S - 3)
                j = rng.integers(i + 2, S - 1)
                toks[b, j: j + 2] = toks[b, i: i + 2]
        toks = torch.from_numpy(toks.astype(np.int64)).to(self.device)
        self.state.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # --- checkpoint integration ---
    def state_dict(self):
        return self.state.to_dict()

    def load_state_dict(self, d):
        self.state = TokenPipelineState.from_dict(d)
