"""Serving runtime: batched greedy decoding with KV caches and the paper's
runtime accuracy<->throughput switch (port of ``repro/launch/serve.py``).

The BinArray §IV-D feature, hardware built for M levels serving with any
``m_active <= M`` at runtime, is ``Request.m_active``: the packed buffers
hold M levels and each request chooses how many to apply (an int, or a
per-decoder-layer schedule).  Each step groups the active slots by their
normalized level count and runs one batched decode per group.  The rows a
grouped decode writes for non-group slots are *transient*: they land at a
position the owning slot has not attended past yet, and that slot's next
real decode overwrites the row before attending to it (the MLA latent
cache and the hybrid's attention caches too).  Recurrent state has no such
invariant: every decode passes a device ``update_mask`` ([B] bool) that is
True on the rows being served (the group's, or the one slot a token-wise
admission warms), and the SSM and hybrid families write back the state of
those rows only, so other slots' state stays bit for bit; the dense and
MoE families ignore it.

Admission runs **bulk prefill**: one ``api.prefill`` forward over the
prompt (B=1) emits the decode cache, which ``api.scatter_cache`` writes
into the slot's row.  Prompt lengths are **bucketed** (powers of two by
default, or an explicit list) where right-padding is exact: positional-KV
caches without a sliding window (a rolling ring would let pad rows wrap
onto live ones).  ``prefill="tokenwise"`` forces the step-wise path.

The JAX package jits one decode and one prefill function per distinct
level count; the port runs eagerly and keeps one specialised config per
level count instead (``cache_sizes`` counts them).  The cache and the
params live on the server's device (the params'); tokens and positions are
staged there each step, and only the argmax tokens and ``last_logits``
come back to the host.

Every family of ``models/api`` is served.  The enc-dec and VLM families
have no bulk prefill and are warmed token-wise, as in the JAX package, and
the server carries no frame or patch embeddings: an enc-dec slot's cross
K/V stays the zeros of ``api.init_cache`` (a uniform softmax over zero
values, a zero cross output), and a VLM cache is ``n_image_tokens`` rows
longer than ``max_len`` and never holds image rows.

A MoE layer's routed experts have a capacity per dispatch group, so a
request's stream can depend on its neighbours, as in the JAX package: a
decode group dispatches all ``max_batch`` rows together (rows of other
slots and other level groups at lower indices take capacity first), and a
prefill's capacity follows its padded length.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    m_active: int | tuple | list | None = None
    #   paper §IV-D runtime mode: None = all levels, int = uniform level
    #   count, sequence = per-decoder-layer schedule (entry i applies to
    #   layer i, last entry extends)
    deadline_s: float | None = None  # absolute time.monotonic() deadline;
    #                                  expired-on-arrival requests are shed
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    last_logits: np.ndarray | None = None   # [V] logits of the newest token


class Server:
    """Single-device batched decode server (greedy sampling).

    ``prefill``: ``"auto"`` (bulk where the family has it), ``"bulk"``
    (required) or ``"tokenwise"``.  ``prefill_buckets``: ``"pow2"``, a
    sorted list (lengths past the last bucket run exact) or ``None``.

    ``stats`` counts, with the JAX package's keys: ``bulk_prefills`` (one
    per bulk admission), ``tokenwise_prefill_steps`` (one per warmed prompt
    token), ``decode_steps`` (one per served group per round),
    ``prefill_bucket_hits`` (bulk prefills at an already-seen
    (m_active, padded length) pair), ``prefill_unique_lens`` (distinct such
    pairs) and ``shed_count`` (requests past their deadline at admit).
    """

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 max_len: int = 256, prefill: str = "auto",
                 prefill_buckets: str | list[int] | None = "pow2"):
        if prefill not in ("auto", "bulk", "tokenwise"):
            raise ValueError(f"unknown prefill mode {prefill!r}")
        if prefill == "bulk" and cfg.family not in api.BULK_PREFILL_FAMILIES:
            raise ValueError(
                f"bulk prefill is not implemented for family={cfg.family!r}")
        if not (prefill_buckets is None or prefill_buckets == "pow2"
                or isinstance(prefill_buckets, (list, tuple))):
            raise ValueError(f"unknown prefill_buckets {prefill_buckets!r}")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_mode = prefill
        self.prefill_buckets = (sorted(prefill_buckets)
                                if isinstance(prefill_buckets, (list, tuple))
                                else prefill_buckets)
        self.cache = api.init_cache(cfg, max_batch, max_len, device=self.device)
        self.pos = np.zeros((max_batch,), np.int32)
        self.slots: list[Request | None] = [None] * max_batch
        # one specialised config per distinct m_active (§IV-D), for decode
        # and for prefill, as the JAX package keeps one jitted function each
        self._decode_cfgs: dict[int | tuple | None, ArchConfig] = {}
        self._prefill_cfgs: dict[int | tuple | None, ArchConfig] = {}
        self._prefill_lens_seen: set[tuple[int | tuple | None, int]] = set()
        self.stats = {"bulk_prefills": 0, "tokenwise_prefill_steps": 0,
                      "decode_steps": 0, "prefill_bucket_hits": 0,
                      "prefill_unique_lens": 0, "shed_count": 0}

    def cache_sizes(self) -> dict:
        """Entry counts of every cache the server holds that grows with
        traffic: the per-``m_active`` configs (at most M+1 plus the
        schedules seen) and the bucketed-prefill length map."""
        return {"decode_fns": len(self._decode_cfgs),
                "prefill_fns": len(self._prefill_cfgs),
                "prefill_lens": len(self._prefill_lens_seen)}

    def cache_gauges(self) -> dict:
        """``name -> callable`` gauge closures for a soak run."""
        return {name: (lambda n=name: float(self.cache_sizes()[n]))
                for name in self.cache_sizes()}

    @property
    def _bulk(self) -> bool:
        return (self.prefill_mode != "tokenwise"
                and self.cfg.family in api.BULK_PREFILL_FAMILIES)

    @property
    def _pad_safe(self) -> bool:
        """Right-padding the prefill is exact only for positional-KV-only
        caches: causal attention keeps rows < L pad-independent and the pad
        rows at positions >= L are transient.  Recurrent state (ssm/hybrid)
        would absorb the pads into the final state; a rolling SWA ring would
        let pad rows wrap onto live ones."""
        return (self.cfg.family in ("dense", "moe")
                and self.cfg.sliding_window is None)

    def _padded_len(self, L: int) -> int:
        """Bucketed prefill length for a true prompt-prefix length ``L``."""
        if self.prefill_buckets is None or not self._pad_safe or L < 1:
            return L
        if self.prefill_buckets == "pow2":
            b = 1
            while b < L:
                b *= 2
        else:
            b = next((x for x in self.prefill_buckets if x >= L), L)
        return max(min(b, self.max_len - 1), L)

    def _norm_m(self, m_active) -> int | tuple | None:
        """Canonical per-request level count: clamp to [1, M], collapse the
        server's default count onto ``None`` and a uniform schedule onto its
        single level, so equal computations share one group and one config."""
        if m_active is None:
            return None
        if isinstance(m_active, (tuple, list)):
            sched = tuple(max(1, min(int(m), self.cfg.quant.M)) for m in m_active)
            if len(set(sched)) > 1:
                return sched
            m_active = sched[0]     # uniform schedule == one level count
        m_active = max(1, min(int(m_active), self.cfg.quant.M))
        default = self.cfg.quant.m_active or self.cfg.quant.M
        return None if m_active == default else m_active

    def _cfg_for(self, m_active: int | tuple | None) -> ArchConfig:
        """The arch config specialised to a normalized §IV-D mode: an int
        sets the uniform level count, a tuple the per-layer schedule."""
        if m_active is None:
            return self.cfg
        if isinstance(m_active, tuple):
            return self.cfg.replace(quant=self.cfg.quant.replace(
                m_active=None, m_schedule=m_active))
        return self.cfg.replace(quant=self.cfg.quant.replace(m_active=m_active))

    def _specialised(self, table: dict, m_active) -> ArchConfig:
        m_active = self._norm_m(m_active)
        cfg = table.get(m_active)
        if cfg is None:
            cfg = table[m_active] = self._cfg_for(m_active)
        return cfg

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)   # a copy: self.pos moves on

    # ------------------------------------------------------------ admit ---
    def admit(self, req: Request) -> bool:
        """Place ``req`` in a free slot and prefill it; False when full or
        when its deadline has passed (shed, counted in ``shed_count``).

        Raises ValueError on malformed requests (empty or oversized prompt,
        or an ``m_active`` entry < 1; entries above M serve all levels).
        """
        if req.deadline_s is not None and req.deadline_s <= time.monotonic():
            self.stats["shed_count"] += 1
            return False
        if req.m_active is not None:
            ms = (req.m_active if isinstance(req.m_active, (tuple, list))
                  else [req.m_active])
            if len(ms) == 0 or any(int(m) < 1 for m in ms):
                raise ValueError(
                    f"Request.m_active entries must be >= 1 (got "
                    f"{req.m_active}); use None to serve all packed levels")
        n_prompt = int(np.asarray(req.prompt).size)
        if n_prompt < 1:
            raise ValueError("Request.prompt must hold at least one token")
        if n_prompt + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({n_prompt}) + max_new_tokens ({req.max_new_tokens})"
                f" exceeds max_len={self.max_len}")
        for i, slot in enumerate(self.slots):
            if slot is None:
                self.slots[i] = req
                self._prefill(i, req)
                return True
        return False

    def _prefill(self, slot: int, req: Request):
        """Warm slot ``slot``'s cache over ``prompt[:-1]``: one bulk prefill
        (right-padded to its bucket where exact) scattered into the slot's
        row, or the token-wise fallback; ``step`` feeds the last prompt
        token and collects the first prediction."""
        self.pos[slot] = 0
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size <= 1:
            return
        if self._bulk:
            L = prompt.size - 1
            Lb = self._padded_len(L)
            toks = prompt[:-1]
            if Lb > L:  # pad KV rows >= L are transient (see _pad_safe)
                toks = np.concatenate([toks, np.zeros((Lb - L,), np.int32)])
            key = (self._norm_m(req.m_active), Lb)
            if key in self._prefill_lens_seen:
                self.stats["prefill_bucket_hits"] += 1
            else:
                self._prefill_lens_seen.add(key)
                self.stats["prefill_unique_lens"] = len(self._prefill_lens_seen)
            cfg = self._specialised(self._prefill_cfgs, req.m_active)
            _, part = api.prefill(cfg, self.params, self._to_device(toks[None]),
                                  max_len=self.max_len)
            self.cache = api.scatter_cache(cfg, self.cache, slot, part)
            self.pos[slot] = prompt.size - 1
            self.stats["bulk_prefills"] += 1
        else:
            for t in prompt[:-1]:
                self._step_one(slot, int(t), req.m_active)

    def _decode(self, m_active, tokens: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """One batched decode of every row, recurrent state written back on
        the rows of ``mask`` only; returns logits [B, V] on the device."""
        batch = {"tokens": self._to_device(tokens), "pos": self._to_device(self.pos),
                 "cache": self.cache, "update_mask": self._to_device(mask)}
        logits, self.cache = api.decode_step(
            self._specialised(self._decode_cfgs, m_active), self.params, batch)
        return logits[:, 0]

    def _step_one(self, slot: int, token: int, m_active=None) -> int:
        B = self.max_batch
        tokens = np.zeros((B, 1), np.int32)
        tokens[slot, 0] = token
        mask = np.zeros((B,), bool)
        mask[slot] = True
        logits = self._decode(m_active, tokens, mask)
        self.pos[slot] += 1
        self.stats["tokenwise_prefill_steps"] += 1
        return int(torch.argmax(logits[slot]))

    # ------------------------------------------------------------- step ---
    def step(self):
        """One batched decode step for every active slot, one decode per
        group of slots with the same normalized ``m_active`` (§IV-D), so a
        single round serves high-accuracy and high-throughput requests side
        by side off the same packed buffers."""
        active = [i for i, r in enumerate(self.slots) if r and not r.done]
        if not active:
            return
        B = self.max_batch
        groups: dict[int | tuple | None, list[int]] = {}
        for i in active:
            groups.setdefault(self._norm_m(self.slots[i].m_active), []).append(i)
        for m_active, idxs in groups.items():
            tokens = np.zeros((B, 1), np.int32)
            mask = np.zeros((B,), bool)
            for i in idxs:
                r = self.slots[i]
                tokens[i, 0] = (r.out_tokens[-1] if r.out_tokens else int(r.prompt[-1]))
                mask[i] = True
            logits = self._decode(m_active, tokens, mask)
            self.stats["decode_steps"] += 1
            rows = torch.tensor(idxs, device=self.device)
            picked = logits[rows]
            nxt = torch.argmax(picked, dim=-1).cpu().numpy()
            host = picked.cpu().numpy()
            for j, i in enumerate(idxs):
                r = self.slots[i]
                r.out_tokens.append(int(nxt[j]))
                r.last_logits = host[j]
                self.pos[i] += 1
                if (len(r.out_tokens) >= r.max_new_tokens
                        or self.pos[i] >= self.max_len - 1):
                    r.done = True
                    self.slots[i] = None

    def run_until_done(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if not any(r and not r.done for r in self.slots):
                break
            self.step()
