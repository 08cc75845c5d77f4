#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Builds the three CUDA kernels from ``src/repro_torch/csrc/`` (one nvcc per
source, all at once) and runs, each phase failing loudly:

  0. the card: nvidia-smi's name and power limit, TF32 off for the plain
     versions (the plain depth-wise version goes through cuDNN);
  1. every kernel against its plain PyTorch version at every instruction
     shape of both programs, m_active 1 and 2, the compiled batch and a
     ragged batch of 3, plus the matmul with group_size 675 (not a multiple
     of 8); tolerance rtol 1e-5, atol 1e-4 (the reference's).  A second tile
     plan of each kernel (``ALT_PLAN``, which no pick may equal) must agree
     bit for bit (torch.equal);
  2. CNN-A (48²x3, 43 classes, M=2) at batch 64 through compile -> execute
     under m_active None, 1 and a per-layer schedule, against
     execute_reference; 2 conv + 3 matmul launches per call;
  3. MobileNetV1 (width 1.0, 224²x3, 1000 classes, M=2) at batch 16, the
     same checks; 14 conv + 13 dwconv + 1 matmul launches per call.  Neither
     network's execute may pick a tile plan;
  4. timings: per kernel and instruction shape, the kernel, its plain
     version and one PyTorch library call for the same core function
     (timed here only, never called by the port), each from CUDA events
     around a CUDA graph of repeated calls; per-forward time of each network.
     ``ms`` is the kernel's wrapper alone, the same work as the library
     call; ``instr_ms`` the whole instruction (a linear one adds its bias
     and ReLU as two more launches);
  5. torch.profiler over three warm execute calls of each network: device
     time by kernel name (top 10) and the device's idle share over the
     window; the chrome traces go to ``chiprun_out/trace_<net>.json``;
  6. serve: MobileNetV1-224 compiled at batch 16 with its golden record
     (3 rungs, self-tested), saved and loaded back onto the card through a
     checksummed checkpoint (``torch.equal``, verified, self-tested), served
     by ``CNNService`` (48 images at rung 0 and 16 at the lowest rung, each
     ``torch.equal`` to ``deploy.execute`` on the padded batch), one
     injected error and one injected NaN retried and reconciled with the
     injector's ledger, an in-memory bit flip caught by the watchdog and
     hot-reloaded, a flipped bit on disk quarantined by
     ``load_latest_good``; then the median ``step()`` over 10 warm batches
     on the host clock, split by CUDA events into assembly + H2D copy,
     ``execute``, and screen + D2H copy.  Its own launches are counted and
     every kernel must run; checkpoints go to ``chiprun_out/serve_ckpt/``;
  7. LM: gemma-2b at full width and depth (18 layers, d_model 2048, 8 heads
     x 256, MQA, d_ff 16384, vocab 256000, GeGLU, tied embeddings), fp32,
     M=2, its weights drawn on the card and binarized there layer by layer.
     The matmul kernel against its plain version at every LM linear shape
     (T = 1 and every row count the phase gives the kernel: the decode
     batch 8, each prefill bucket, 16 and 64; m_active 1 and 2; the second
     plan bit-identical); ``Server(max_batch=8, max_len=256)`` serving 8 requests
     (prompts of 5-60 tokens, 16 new tokens, m_active None / 1 / a per-layer
     schedule) with 18 x 7 matmul launches per decode group step, a mixed
     request equal to the same request served alone, bulk admission equal
     to token-wise admission; the card against the plain versions on a CPU
     copy cut to 2 layers (prefill of 16 tokens + 2 decode steps); then the
     admission of a 64-token prompt, one decode step at 8 active slots
     (CUDA events and host clock), a profiler window of 3 decode steps
     (``chiprun_out/trace_gemma.json``: kernels by name, idle share, the
     matmul kernel against the LM head's product), and per LM linear shape
     the kernel, its plain version, ``x @ W_hat`` and the bound; then the
     dense LMs in their own dtype, bf16, with packed M=2 linears on the
     kernel's bf16-x route (each launch reads the bf16 rows as they are):
     (7b) phase 7's packed gemma-2b, all 18 layers, its embedding and norms
     cast to bf16: every bf16-x launch at each LM linear shape and row count
     ``torch.equal`` to the same launch on ``x.float()`` at the picked and
     the second plan, ``ops.binary_matmul`` running no aten op on x but
     views; phase 7's 8 requests served with 126 launches per pass, every
     one on bf16 x, a second run bit-equal; bulk admission against
     token-wise and 2 layers against the plain versions on the CPU within
     rtol 2e-2 / atol 2e-2·max|x|; the 64-token admission and the decode
     step at 8 slots beside 7a's fp32 ones, and a profile of 3 bf16
     decode steps beside 7a's; per linear the kernel, its plain version
     and bf16 ``x @ W_hat``, the launcher alone on bf16 x and on its fp32
     copy in turns, and the bf16-x route against the route before it (x
     cast to fp32, the fp32 launch, y cast back); (7c) h2o-danube-1.8b, 24 layers at
     full width, its published 4096-token window: one 4200-token prompt
     admitted in bulk wraps the ring, 8 decoded tokens' logits within the
     bf16 tolerance of the teacher-forced forward over the same tokens
     (168 launches per pass), 2 layers with the window cut to 16 against
     the CPU; (7d) qwen3-14b (qk-norm) and codeqwen1.5-7b (``qkv_bias``)
     at full width cut to 4 layers: served with 28 launches per pass, 2
     layers against the CPU;
  8. training, after phase 7's model is freed: (a) the paper's Table II
     pipeline on CNN-A (``tools/torch_train_cnn_a.py``: 300 fp32 AdamW steps
     at 1e-3, Algorithm 2 with K_iters 25, 150 STE steps at 1e-4, batch 64,
     512 eval images), then ``deploy.execute`` of the retrained weights on
     ``binary_conv`` and ``binary_matmul``: both losses fall (last 20 steps
     against the first 20), execute's logits within rtol 1e-4 / atol
     1e-4·max|logit| of the fake-quant forward, the deployed accuracy within
     0.02 of the retrained one, 2 + 3 launches; (b) gemma-2b at full width
     and depth in bf16 with remat, fake-quant M=2, K_iters 8, three
     ``build_train_step`` steps at 8 x 64 tokens (1 warm, 2 timed): losses
     finite, every leaf's moments moved, every weight leaf changed (a norm
     scale at 1.0 does not move in bf16 at this warmup's lr); Algorithm 2
     timed alone over the 126 linears, and the peak memory; (c) ``Trainer``
     at reduced(gemma_2b), fp32, deterministic algorithms: a run killed at
     step 5 and resumed ends ``torch.equal`` to the uninterrupted one, one
     injected non-finite loss is skipped and counted (checkpoints in
     ``chiprun_out/train_ckpt/``); (d) whisper-medium and internvl2-2b at
     published width and depth in bf16 with remat, fake-quant M=2: one step
     at 8 x 64 tokens with random frame or patch embeddings, the whole
     state through host memory and back, a second step from it; both
     losses finite, no NaN skip, every leaf's moments moved, every weight
     leaf changed; the steps' ms and the peak memory;
  9. the verification tier: (a) fuzz: 128 random networks
     (``testing/fuzz.random_network`` seeds 0-127, the JAX package's draws)
     compiled on the card with zero verifier ERRORs, ``execute`` at each
     network's execute batch and m_active None and 1 torch.equal to the
     per-call kernel path (each layer through ``kernels.ops`` with its own
     plan pick) and within rtol 1e-4 / atol 1e-4·max|logit| of
     ``execute_reference``; every rare shape drawn at least once (pool 3,
     kh != kw, stride 2 with a pool, VALID, C not a multiple of 8, 1x1 at
     stride 2, depth-wise stride 2, M = 1, an execute batch over the
     compiled one); (b) ``trace_lint`` on phases 2-3's programs: no library
     conv or product, plan pick or float64 at m_active None, 1 and per
     layer, and one launch per instruction over 3 repeats; (c) soaks
     through ``run_soak`` + ``assert_flat`` at the JAX defaults, every
     gauge (live device bytes included) exactly flat after warmup: the
     executor over CNN-A and MobileNetV1-224 at batch 16 (520 steps),
     ``CNNService`` under fault storms (324 steps, every injected fault
     reconciled), the checkpoint cycle (120 steps), ``Server`` on reduced
     gemma-2b (1100 steps, >= 2000 decode steps) and on reduced
     h2o-danube, qwen3 and codeqwen (100 steps each), each server's first
     4 rounds equal to the same scenario on the CPU (tokens; logits within
     rtol 2e-5 / atol 5e-5).  Trend CSVs go to ``chiprun_out/soak/``;
 10. the MoE family at published widths, cut in depth only, fp32, M=2
     (K_iters 8), weights drawn on the card and each layer binarized as
     drawn (the routed expert banks stay fp32, as in the JAX package):
     (a) DeepSeek-V3 with its 3 leading dense layers and 1 MoE layer (MLA
     with q-LoRA, 256 routed experts top-8 + 1 shared, vocab 129280, the
     MTP head built): the matmul kernel against its plain version at its 9
     linear shapes and phase 7's row counts; the full-width MoE layer
     against a plain per-token reference (a 64-token prefill and an 8-row
     decode: expert ids equal, the same dropped picks, rtol 1e-4 /
     atol 1e-4·max|y|); the first dense layer on the card against a CPU
     copy (prefill of 16 tokens + 2 decode steps); ``Server`` serving phase 7's
     8 requests with 28 matmul launches per admission and per decode group
     step, a second run giving the same tokens and bit-equal logits;
     admission of 64 tokens, the decode step at 8 slots beside its bytes
     bound, a profiler window of 3 decode steps
     (``chiprun_out/trace_deepseek.json``: idle share, the matmul kernel,
     the routed-expert and absorbed-MLA ``bmm``s, the LM head); (b) grok-1
     with 2 MoE layers (8 experts top-2 at 32768, GQA 48/8): the kernel at
     its 2 attention shapes, ``Server`` with 8 launches per pass, the
     timed decode step and its bound; (c) reduced DeepSeek-V3 and grok-1
     (binary M=2) served on the card against a CPU copy for 4 rounds of 8
     mixed-mode requests (tokens equal, logits within rtol 2e-5 /
     atol 5e-5, every MoE call's expert ids equal), and one fake-quant
     ``build_train_step`` step of reduced DeepSeek-V3 against the CPU
     (loss, ce_loss, load_balance_loss, mtp_loss within rtol 1e-5);
 11. the SSM and hybrid families at published widths and depths, fp32, M=2
     (K_iters 8), weights drawn on the card and each layer binarized as
     drawn (the Mamba2 dynamics and the norms stay fp32), after phase 10's
     models are freed: (a) mamba2-2.7b (64 layers, d_model 2560, 80 heads x
     64, state 128, vocab 50280): the matmul kernel against its plain
     version at its 2 linear shapes (2560->10576 leaves a 16-column tail)
     and every row count of the phase; ``ssd_chunked`` at full width on the
     card against a float64 token-by-token recurrence (L = 64, 256 and the
     prime 257, chunk 1: y and the final state within rtol 2e-4 /
     atol 2e-4); bulk prefill of 32 tokens against 32 token-wise decode
     steps (every cache leaf and the next logits within rtol 1e-4 /
     atol 1e-4·max|x|); the first 2 layers on the card against a CPU copy;
     ``Server`` serving phase 7's 8 requests with 128 matmul launches per
     admission and per decode group step, a second run bit-equal, one
     request of each mode alone (in 8 slots: logits rtol 1e-5 / atol 1e-5;
     at ``max_batch=1``: rtol 2e-5 / atol 5e-5) equal to the mix, slot 0's state ``torch.equal`` across the other 7
     admissions and the decode groups it is not in; admission of 64 tokens,
     the decode step at 8 slots beside its bytes bound, a profiler window
     of 3 decode steps (``chiprun_out/trace_mamba2.json.gz``: idle share, the
     matmul kernel, the ops on the recurrent state, the LM head); (b)
     zamba2-7b (81 Mamba2 layers and 13 shared-block points, d_model 3584,
     32 x 112 MHA, d_ff 14336, state 64, vocab 32000): the same checks but
     the SSD one at its 6 linear shapes, 266 launches per pass, the first 6
     layers and their shared block against the CPU
     (``chiprun_out/trace_zamba2.json.gz``); (c) reduced mamba2 and zamba2
     served on the card against a CPU copy for 4 rounds and one fake-quant
     train step of each against the CPU (every metric within rtol 1e-5,
     the card's gradients finite);
 12. the enc-dec and VLM families at published widths and depths, fp32,
     M=2 (K_iters 8), each layer binarized as drawn, after phase 11's
     models are freed: (a) whisper-medium (24 encoder + 24 decoder layers,
     d_model 1024, 16 x 64 MHA, d_ff 4096 GELU, vocab 51865 tied,
     ``encoder_len`` 1500): the matmul kernel against its plain version at
     its 3 linear shapes and every row count of the phase (the encoder's
     1500 x 8); ``init_encdec_cache`` over 8 random frame windows (192
     matmul launches), timed beside its operations bound; 16 greedy
     ``decode_step``s at 8 rows (192 launches each) and the teacher-forced
     ``forward`` of the same tokens (384 launches) within rtol 1e-4 /
     atol 1e-4·max|x| of the decode loop's logits; 2 encoder + 2 decoder
     layers on the card against a CPU copy (encoder output, cross K/V, 4
     decode steps); ``Server`` serving 8 requests (prompts of 4-16 tokens,
     m_active None / 1, token-wise admission) with 192 launches per
     admission step and per decode group step, a second run bit-equal;
     admission of 64 tokens, the decode step at 8 slots beside its bytes
     bound, a profiler window of 3 decode steps
     (``chiprun_out/trace_whisper.json.gz``: idle share, the matmul kernel,
     the cross-attention ops, the LM head); (b) internvl2-2b (24 layers,
     d_model 2048, GQA 16 / 8 x 128, d_ff 8192 SwiGLU, vocab 92553, 256
     image tokens): the kernel at its 4 shapes, ``forward`` of 2 x 256 patch
     embeddings + 64 tokens (168 launches), 2 layers against a CPU copy, a
     prefix of zeros against none, ``Server`` with 168 launches per pass,
     the timed decode step; (c) reduced whisper and internvl2 served on the
     card against a CPU copy for 4 rounds and one fake-quant train step of
     each against the CPU;
 13. the mesh (``distributed/`` over ``torch.distributed``): (a)
     ``plan_mesh`` and ``verify_mesh_plan`` on the abstract MobileNetV1-224
     (batch 16) at 2x1, 1x2, 2x2 and 1x4 and CNN-A (batch 64) at 2x1 and
     4x1, each plan clean and its bd layers and ``mesh_totals`` equal to
     the JAX planner's; (b) phases 2-3's programs saved
     (``chiprun_out/mesh_prog/``) and loaded by ranks spawned with
     ``run_local`` on the one card (gloo): CNN-A 2x1 and MobileNet 2x1 and
     1x2 (world 2), MobileNet 2x2 (world 4), each at m_active None, 1 and
     per layer, MobileNet 2x1 also at a ragged batch of 15, every forward
     ``torch.equal`` to single-process ``execute``, no plan pick, one launch
     per instruction per rank; (c) ``CNNService(mesh_plan=...)`` at
     MobileNet 1x2 over 10 batches of 16 on both ranks, equal to the plain
     service; (d) the median sharded forward (rank 0, CUDA events) beside
     single-process ``execute``: every rank shares one card, so these say
     nothing of scaling.  Numbers under ``"mesh"``;
 14. the sharded LM (``sharding/``, ``launch/{mesh,steps,pipeline}.py``
     over DTensor): (a) the rules' specs and per-rank parameter bytes of
     gemma-2b's fp and packed trees at 2x1, 1x2, 2x2 and 16x16; (b) the
     packed gemma-2b (phase 7's build, fp32, M=2) saved to a temporary
     checkpoint and restored by ranks spawned with ``run_local`` on the one
     card (gloo), whose ``build_serve_step`` decode steps at 8 slots
     (2x2 and 2x1 FSDP and TP-only, 1x2 once: with one data rank the two
     are the same layout; bf16 at 2x2 in both) hold every binary
     linear's columns ``torch.equal`` to the single-process kernel's, the
     logits within rtol 1e-4 / atol 1e-4·max|logit| (bf16: 2e-2) of
     single-process ``decode_step`` and 126 matmul launches per rank per
     step, plus a 1x2 prefill of 2 x 64 tokens; (c) gemma-2b cut to 2
     layers, fp32: a dense mesh train step at 2x1 and at 1x2 with each
     leaf's update within 1e-3 of single-process's; fake-quant: a
     ``Trainer``'s step at 2x1 that then saves, and a ``Trainer`` at 1x2
     that resumes from that save (``restore(shardings=)``: params and
     momenta ``torch.equal``) and takes the second step, each held against
     single-process; (d) a
     GPipe pipeline of 2 full-width packed layers against
     ``reference_apply``; (e) the sequence-sharded prefill
     (``seq_sharded``) of the packed gemma-2b, one prompt of 512 tokens
     (B = 1) at 2x1 and 2x2, TP-only: 126 launches per rank per pass,
     each on the rank's 256 rows of the sequence, each linear's output
     ``torch.equal`` to the single-process prefill kernel's at the same
     rows and columns, the logits within 1e-4·max|logit|; (f) the 2-layer
     cut, dense, with binary gradient compression (M=2): one mesh step
     at 2x1 and one at 1x2 against a single-process compressed step,
     each leaf's alphas within rtol 1e-5, its reconstructed gradient
     within 1e-5·sum(alpha) (the same signs) but where the single-process
     residual at some level lies within 1e-4·alpha, or within the two
     sides' own gradient difference, of 0 (counted), its update and error
     within 1e-3 of their own L2 there.  Times are rank 0's beside the
     single-process step: no scaling claim.  Numbers under ``"mesh_lm"``;
 15. the dry run (``launch/{cost_analysis,steps,dryrun,hillclimb}.py``):
     (a) ``python -m repro_torch.launch.dryrun`` on gemma-2b decode_32k
     over a cuda-typed fake process group of 256 ranks, dense and as
     hillclimb cell D's ``tponly_binM2`` (two subprocesses with a timeout,
     run on the host beside phase 14's ranks):
     both records ok, the packed one counting 126 ``binary_matmul`` calls
     per device, model_flops 2 · N_active · 128; (b) on phase 14b's packed
     gemma-2b, one decode group step at 8 slots under ``CostCounter``: the
     logits ``torch.equal`` to the step without it, the counted calls equal
     to the launch counter's delta, the counted kernel MACs and bytes equal
     to phase 7's per-call bound inputs.  Numbers under ``"dryrun"``.

Weights are random, drawn from a seeded generator.  The logits of phases 2
and 3 are compared with rtol 1e-4 and atol 1e-4·max|logit| (a relative
floor: the reference's random MobileNet init shrinks activations to ~1e-13
by the head, and 28 layers of fp32 sums run in another order on each side).

Prints a ``{"kernels": [...]}`` JSON line (``launches`` counts the main
paths of phases 2, 3, 7 (7b-7d under ``lm_bf16_launches``), 8a, 9a, 9c, 10, 11, 12, 13, 14 and 15b, ``cnn_launches`` phases 2-3,
``serve_launches`` phase 6, ``lm_launches`` phase 7's serving,
``train_launches`` phase 8a's execute, ``fuzz_launches`` phase 9a's
``execute`` calls, ``soak_launches`` phase 9c's soaks, ``moe_launches``
phase 10's serving, ``ssm_launches`` phase 11's, ``encdec_launches``
phase 12's, ``mesh_launches`` phase 13's ranks, ``mesh_lm_launches``
phase 14's and ``dryrun_launches`` phase 15b's), nvidia-smi's line,
and last ``{"ok": true, "device": {...}}``; per-instruction numbers go to
``chiprun_out/chip_smoke.json``, phase 7's under ``"lm"``, phase 8's under
``"train"``, phase 9's under ``"verify"``, phase 10's under ``"moe"``,
phase 11's under ``"ssm"``, phase 12's under ``"encdec"``, phase 13's under
``"mesh"``, phase 14's under ``"mesh_lm"``, phase 15's under ``"dryrun"``.  Exits non-zero,
printing no result, without
a card or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import gzip
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch import deploy
    from repro_torch.core import binarize as bz
    from repro_torch.core.binconv import pad_nhwc
    from repro_torch.core.binlinear import QuantConfig
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.launch import steps as train_steps
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import binary_matmul as bmk
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import api, common as cm, transformer as tf
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import hybrid as hybrid_mod, ssm as ssm_mod
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.kernels.binary_conv import unpack_taps
    from repro_torch.kernels.binary_dwconv import unpack_dw_taps
    from repro_torch.models import cnn
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.serve_cnn import CNNService, default_ladder
    from repro_torch.testing.faults import FaultInjector, FaultPlan, inject_faults
    from repro_torch.analysis import trace_lint, verify_mesh_plan, verify_program
    from repro_torch import distributed as mesh_dist
    from repro_torch.sharding import placement as pl
    from repro_torch.testing import fuzz
    from repro_torch.testing import scenarios as soak_sc
    from repro_torch.testing.soak import TrendViolation, run_soak
except ImportError as e:
    raise SystemExit(f"chip_smoke: FAILED: the port is not importable from "
                     f"{ROOT / 'src'}: {e}") from e

FP32_FLOPS = 67e12         # H100 SXM fp32 (non-tensor) peak, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 bandwidth, NVIDIA data sheet
RTOL, ATOL = 1e-5, 1e-4
TPU_KERNELS = {  # name -> (CUDA source, TPU kernel it replaces)
    "binary_conv": ("src/repro_torch/csrc/binary_conv.cu",
                    "src/repro/kernels/binary_conv.py:416"),
    "binary_dwconv": ("src/repro_torch/csrc/binary_dwconv.cu",
                      "src/repro/kernels/binary_dwconv.py:168"),
    "binary_matmul": ("src/repro_torch/csrc/binary_matmul.cu",
                      "src/repro/kernels/binary_matmul.py:92"),
}
KERNEL_OF = {"conv": "binary_conv", "dwconv": "binary_dwconv", "linear": "binary_matmul"}
ALT_PLAN = {"conv": (64, 32), "dwconv": (2, 256), "linear": (2, 64)}
EXPECTED_LAUNCHES = {
    "cnn_a": {"binary_conv": 2, "binary_dwconv": 0, "binary_matmul": 3},
    "mobilenet": {"binary_conv": 14, "binary_dwconv": 13, "binary_matmul": 1},
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def single(instr, plan, batch: int):
    """A one-instruction program over the instruction's post-pre input."""
    one = dataclasses.replace(instr, pre="none", plan=deploy.TilePlan(*plan))
    return deploy.BinArrayProgram((one,), instr.name,
                                  (batch,) + tuple(instr.stats.in_shape[1:]))


def layer_input(instr, batch: int, gen: torch.Generator, dev) -> torch.Tensor:
    return torch.randn((batch,) + tuple(instr.stats.in_shape[1:]), generator=gen).to(dev)


def check_kernels(programs: dict, gen: torch.Generator, dev) -> dict:
    """Phase 1: each kernel against its plain version at every instruction
    shape; returns the largest |kernel - plain| per kernel."""
    max_err = {k: 0.0 for k in TPU_KERNELS}

    def compare(where, instr, batch, m, alt_plan):
        x = layer_input(instr, batch, gen, dev)
        got = deploy.execute(single(instr, instr.plan, batch), x, m)
        want = deploy.execute_reference(single(instr, instr.plan, batch), x, m)
        err = float((got - want).abs().max())
        kern = KERNEL_OF[instr.kind]
        max_err[kern] = max(max_err[kern], err)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"{where} batch {batch} m {m}: kernel vs plain max |d| {err:.3g}")
        if alt_plan is not None:
            alt = deploy.execute(single(instr, alt_plan, batch), x, m)
            if not torch.equal(got, alt):
                fail(f"{where} batch {batch} m {m}: plans {tuple(instr.plan)} and "
                     f"{alt_plan} differ")

    checks = 0
    for arch, program in programs.items():
        for instr in program.instrs:
            if tuple(instr.plan) == ALT_PLAN[instr.kind]:
                fail(f"{arch}/{instr.name}: the picked plan is the second plan "
                     f"{ALT_PLAN[instr.kind]}, so the bit-identity check would not bite")
            for batch in (program.input_shape[0], 3):
                for m in (1, 2):
                    compare(f"{arch}/{instr.name}", instr, batch, m, ALT_PLAN[instr.kind])
                    checks += 1
    # the matmul with alpha groups of 675 rows (not a multiple of 8), fc1's shape
    fc1 = programs["cnn_a"].instrs[2]
    approx = bz.algorithm2(torch.randn(1350, 340, generator=gen).to(dev), 2, K_iters=8,
                           group_size=675)
    grouped = dataclasses.replace(
        fc1, B_packed=bz.pack_bits(bz.pad_rows_to_byte(approx.B)).contiguous(),
        alpha=approx.alpha.contiguous(), group_size=675)
    for batch in (fc1.stats.in_shape[0], 3):
        for m in (1, 2):
            compare("cnn_a/fc1 group 675", grouped, batch, m, ALT_PLAN["linear"])
            checks += 1
    torch.cuda.synchronize()
    print(f"phase 1: {checks} kernel-vs-plain checks passed (rtol {RTOL}, atol {ATOL}), "
          f"second plans bit-identical; max |d| {json.dumps(max_err)}")
    return max_err


def run_main_path(phase: int, arch: str, program, x: torch.Tensor) -> dict:
    """Phases 2 and 3: execute under three schedules against
    execute_reference; returns the launches counted over the three calls."""
    total = {k: 0 for k in TPU_KERNELS}
    classes = program.instrs[-1].stats.out_shape[1]
    for m_active in (None, 1, [1 + (i % 2) for i in range(len(program))]):
        ops.reset_launch_counts()
        picks = ops.plan_pick_count()
        got = deploy.execute(program, x, m_active)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if ops.plan_pick_count() != picks:
            fail(f"{arch}: execute made {ops.plan_pick_count() - picks} plan picks")
        if counts != EXPECTED_LAUNCHES[arch]:
            fail(f"{arch} m_active={m_active}: launches {counts} != "
                 f"{EXPECTED_LAUNCHES[arch]}")
        for k, v in counts.items():
            total[k] += v
        want = deploy.execute_reference(program, x, m_active)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if tuple(got.shape) != (x.shape[0], classes):
            fail(f"{arch}: logits shape {tuple(got.shape)} != {(x.shape[0], classes)}")
        if not bool(torch.isfinite(got).all()) or scale == 0.0:
            fail(f"{arch}: logits not finite, or the reference's all zero")
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
            fail(f"{arch} m_active={m_active}: logits max |d| {err:.3g} "
                 f"(max |logit| {scale:.3g})")
        print(f"phase {phase}: {arch} m_active={m_active}: logits {tuple(got.shape)}, "
              f"max |logit| {scale:.4g}, max |d| vs plain {err:.3g}; launches {counts}; "
              f"no plan pick")
    return total


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around replays of a CUDA graph
    of ``reps`` calls (no host work inside the timed region)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def loop_ms(fn, reps: int = 10) -> float:
    """Time of one call issued from the host, host work included."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def library_call(instr, x: torch.Tensor):
    """One PyTorch call for the instruction's core function on the
    reconstructed weights (all levels): x @ W_hat, F.conv2d, or F.conv2d
    with groups=C; SAME padding is applied outside the call."""
    if instr.kind == "linear":
        B = bz.unpack_bits(instr.B_packed, instr.B_packed.shape[1] * 8)[:, :instr.K]
        W_hat = bz.reconstruct(bz.BinApprox(B, instr.alpha, instr.group_size))
        return lambda: x @ W_hat
    C = x.shape[-1]
    padding = instr.padding if instr.kind == "conv" else "SAME"
    xp = pad_nhwc(x, instr.kh, instr.kw, instr.stride, padding).permute(0, 3, 1, 2)
    if instr.kind == "conv":
        W_hat = bz.reconstruct(bz.BinApprox(unpack_taps(instr.B_tap_packed, C),
                                            instr.alpha, instr.group_size))
        w = W_hat.reshape(instr.kh, instr.kw, C, -1).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(xp, w, stride=instr.stride)
    W_hat = torch.einsum("mtc,mc->tc", unpack_dw_taps(instr.B_tap_packed, C).float(),
                         instr.alpha)
    w = W_hat.reshape(instr.kh, instr.kw, C).permute(2, 0, 1).unsqueeze(1).contiguous()
    return lambda: F.conv2d(xp, w, stride=instr.stride, groups=C)


def work(instr, batch: int) -> tuple[int, int]:
    """(bytes, flops) the instruction's function must move and do at all
    levels: each input read once (x, packed weights, alpha, bias), the
    output written once; 2 flops per fp-equivalent MAC."""
    weights = instr.B_packed if instr.kind == "linear" else instr.B_tap_packed
    x_numel = batch * math.prod(instr.stats.in_shape[1:])
    out_numel = batch * math.prod(instr.stats.out_shape[1:])
    nbytes = (4 * x_numel + weights.numel() + 4 * instr.alpha.numel()
              + 4 * instr.bias.numel() + 4 * out_numel)
    return nbytes, 2 * instr.stats.macs * batch


def time_kernels(programs: dict, gen: torch.Generator, dev) -> tuple[list, dict]:
    """Phase 4 per instruction: kernel, plain version, library call, bound."""
    rows = []
    totals = {k: {"ms": 0.0, "instr_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bytes": 0, "flops": 0} for k in TPU_KERNELS}
    for arch, program in programs.items():
        batch = program.input_shape[0]
        for instr in program.instrs:
            kern = KERNEL_OF[instr.kind]
            x = layer_input(instr, batch, gen, dev)
            prog1 = single(instr, instr.plan, batch)
            instr_ms = graph_ms(lambda: deploy.execute(prog1, x))
            # a linear instruction adds its bias and ReLU outside the kernel:
            # time the kernel alone, the same work as x @ W_hat
            ms = graph_ms(lambda: ops.binary_matmul(
                x, instr.B_packed, instr.alpha, K=instr.K, group_size=instr.group_size,
                plan=instr.plan)) if instr.kind == "linear" else instr_ms
            plain_ms = graph_ms(lambda: deploy.execute_reference(prog1, x), reps=5)
            lib_ms = graph_ms(library_call(instr, x))
            nbytes, flops = work(instr, batch)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            rows.append({"net": arch, "layer": instr.name, "kernel": kern,
                         "in_shape": [batch] + list(instr.stats.in_shape[1:]),
                         "plan": list(instr.plan), "ms": ms, "instr_ms": instr_ms,
                         "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": bound, "bytes": nbytes,
                         "flops": flops})
            for key, val in (("ms", ms), ("instr_ms", instr_ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bytes", nbytes), ("flops", flops)):
                totals[kern][key] += val
            print(f"  {arch} {instr.name} {kern} in {rows[-1]['in_shape']} plan "
                  f"{tuple(instr.plan)}: kernel {ms:.5f} ms, instruction {instr_ms:.5f} ms, "
                  f"plain {plain_ms:.5f} ms, "
                  f"library {lib_ms:.5f} ms, bound {bound:.5f} ms")
    return rows, totals


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_split(events: list) -> dict:
    """Device time by kernel name and the device's idle share, from the
    ``traceEvents`` of a chrome trace.  The window runs from the first span
    (host or device) to the end of the last device span; busy time is the
    union of the device spans."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if not device:
        fail("the profiler recorded no device time")
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    busy, reach = 0.0, -math.inf
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                              for e in device):
        if stop > reach:
            busy += stop - max(start, reach)
            reach = stop
    window = reach - min(float(e["ts"]) for e in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_us": window, "busy_us": busy, "idle_share": 1.0 - busy / window,
            "device_us_by_name": dict(top)}


def profile_forward(arch: str, program, x: torch.Tensor, out_dir: Path,
                    calls: int = 3) -> dict:
    """Phase 5: torch.profiler over ``calls`` warm execute calls, after one
    traced warm-up call that is dropped (the tracer's first launch pays for
    its buffers); writes the chrome trace to ``out_dir`` and prints the ten
    kernels with the most device time and the device's idle share over the
    window."""
    from torch.profiler import ProfilerActivity, profile, schedule
    path = out_dir / f"trace_{arch}.json"
    deploy.execute(program, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(1 + calls):
            deploy.execute(program, x)
            torch.cuda.synchronize()
            prof.step()
    split = device_split(json.loads(path.read_text())["traceEvents"])
    print(f"phase 5: {arch} profiler over {calls} execute calls: window "
          f"{split['window_us'] / 1e3:.4f} ms, device busy {split['busy_us'] / 1e3:.4f} ms, "
          f"idle share {split['idle_share']:.4f}; trace {path.relative_to(ROOT)}")
    for name, us in list(split["device_us_by_name"].items())[:10]:
        print(f"  {us / calls / 1e3:.5f} ms per call  {name[:110]}")
    return split

SERVE_BATCH = 16


def serve_phase(params: dict, quant, gen: torch.Generator, dev, out_dir: Path) -> dict:
    """Phase 6: the serving path of MobileNetV1-224 at batch 16 on the card.
    Every piece of the path runs inside ``counted`` (launch counts set to 0
    just before it and added up just after); the reference ``execute``
    calls that check its answers run outside it."""
    launches = {k: 0 for k in TPU_KERNELS}

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in ops.launch_counts().items():
            launches[k] += v
        return out

    def check_served(svc, done, n, rung):
        if len(done) != n or any(r.status != "done" for r in done):
            fail(f"serve: {[r.status for r in done]} (want {n} done), {svc.stats}")
        want = deploy.execute(svc.program, svc.last_batch, svc.last_schedule).cpu()
        for r in done:
            if r.rung != rung or r.m_schedule != svc.last_schedule \
                    or not torch.equal(r.logits, want[r.batch_index]):
                fail(f"serve: request {r.id} at rung {r.rung} is not torch.equal to "
                     f"execute on the padded batch at {svc.last_schedule}")

    def images(n):
        return [torch.randn(224, 224, 3, generator=gen).numpy() for _ in range(n)]

    shape = (SERVE_BATCH, 224, 224, 3)
    t0 = time.time()
    program = counted(lambda: deploy.compile(params, "mobilenet", quant, shape,
                                             device=dev, golden=True))
    compile_s = time.time() - t0
    rungs = program.golden.schedules()
    if len(rungs) != 3 or program.golden.device != dev.type:
        fail(f"serve: golden record {len(rungs)} rungs on {program.golden.device!r}, "
             f"want 3 on {dev.type!r}")
    t0 = time.perf_counter()
    again = counted(lambda: deploy.compute_golden(program))
    golden_s = time.perf_counter() - t0
    if again != program.golden:
        fail("serve: a second compute_golden gave other digests on the card")
    t0 = time.perf_counter()
    if counted(lambda: deploy.self_test(program)) != 3:
        fail("serve: self_test did not check 3 rungs")
    selftest_ms = (time.perf_counter() - t0) * 1e3
    print(f"phase 6: golden rungs {[list(r) for r in rungs]} (front half = first "
          f"{len(program) // 2} instructions); compile with golden {compile_s:.2f} s, "
          f"compute_golden {golden_s * 1e3:.1f} ms, self_test of 3 rungs "
          f"{selftest_ms:.1f} ms; digests {[d for _, d in program.golden.digests]}")

    ckpt_dir = out_dir / "serve_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir))
    deploy.save_program(mgr, 1, program)
    like = deploy.abstract_program("mobilenet", quant, shape, device=dev)
    loaded = counted(lambda: deploy.load_program(mgr, 1, like, verify=True))
    if loaded.device != program.device or loaded.golden != program.golden:
        fail(f"serve: loaded program on {loaded.device}, golden "
             f"{'equal' if loaded.golden == program.golden else 'differs'}")
    for a, b in zip(program.instrs, loaded.instrs):
        for f in a.TREE_FIELDS:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                fail(f"serve: {a.name}.{f} differs after the checkpoint round trip")
    counted(lambda: deploy.self_test(loaded))
    print(f"phase 6: checkpoint round trip onto {loaded.device}: "
          f"{sum(len(i.TREE_FIELDS) for i in loaded.instrs)} tensors torch.equal, "
          f"verified, golden re-attached, self_test passed")

    ladder = default_ladder(program)
    svc = CNNService(program, batch_size=SERVE_BATCH, max_queue=48, selftest_every=2,
                     checkpoint_manager=mgr, restore_like=like)
    if any(svc.submit(im).status != "queued" for im in images(48)):
        fail(f"serve: not all 48 images admitted: {svc.stats}")
    for _ in range(3):
        check_served(svc, counted(svc.step), SERVE_BATCH, 0)
    low = CNNService(program, batch_size=SERVE_BATCH, initial_rung=len(ladder) - 1)
    for im in images(16):
        low.submit(im)
    check_served(low, counted(low.step), SERVE_BATCH, len(ladder) - 1)
    if low.last_schedule != ladder[-1]:
        fail(f"serve: lowest rung served {low.last_schedule}, ladder ends {ladder[-1]}")
    print(f"phase 6: served 48 images at rung 0 and 16 at rung {len(ladder) - 1} "
          f"{list(ladder[-1])}, each torch.equal to execute; watchdog "
          f"{svc.stats['selftest_runs']} self-tests")

    faults = {}
    for kind, plan in (("error", FaultPlan(error_rate=1.0)), ("nan", FaultPlan(nan_rate=1.0))):
        with inject_faults(plan) as inj:
            def clear_on_sleep(dt, inj=inj):
                time.sleep(dt)
                inj.plan = FaultPlan()
            fsvc = CNNService(program, batch_size=SERVE_BATCH, backoff_s=0.001,
                              sleep=clear_on_sleep)
            for im in images(4):
                fsvc.submit(im)
            done = counted(fsvc.step)
        st = fsvc.stats
        check_served(fsvc, done, 4, 0)
        seen = st["exec_exceptions"] if kind == "error" else st["nonfinite_detected"]
        other = st["nonfinite_detected"] if kind == "error" else st["exec_exceptions"]
        if not (st["retries"] == 1 and seen == inj.counts[kind] == 1 and other == 0):
            fail(f"serve: injected {kind} not reconciled: stats {st}, injector {inj.counts}")
        faults[kind] = {"stats": st, "injected": inj.counts}
    print("phase 6: one injected error and one injected NaN each retried once and "
          "served clean; stats reconcile with the injector's counts")

    for im in images(16):
        svc.submit(im)
    check_served(svc, counted(svc.step), SERVE_BATCH, 0)
    clean = svc.program
    svc.program = FaultInjector(FaultPlan(seed=0)).flip_bit_in_program(svc.program)
    for im in images(16):
        svc.submit(im)
    done = counted(svc.step)
    st = svc.stats
    if st["selftest_failures"] != 1 or st["reloads"] != 1 or svc.last_reload_step != 1:
        fail(f"serve: in-memory bit flip not recovered: {st}")
    if svc.program.device != program.device:
        fail(f"serve: reloaded onto {svc.program.device}")
    check_served(svc, done, SERVE_BATCH, 0)
    want = deploy.execute(clean, svc.last_batch, svc.last_schedule).cpu()
    if not all(torch.equal(r.logits, want[r.batch_index]) for r in done):
        fail("serve: the batch after the hot reload differs from the clean program's")
    step_dir = deploy.save_program(mgr, 2, program)
    flipped = FaultInjector(FaultPlan(seed=0)).flip_bit_on_disk(step_dir)
    step, good = counted(lambda: deploy.load_latest_good(mgr, like))
    if step != 1 or [s for s, _ in mgr.quarantined] != [2] or good.device != program.device:
        fail(f"serve: load_latest_good returned step {step}, quarantined "
             f"{mgr.quarantined}")
    print(f"phase 6: in-memory bit flip caught by the watchdog and hot-reloaded from "
          f"step 1 (selftest_failures 1, reloads 1, next batch torch.equal to the clean "
          f"program's); disk flip in {flipped} of step 2 quarantined "
          f"({mgr.quarantine_dirs()}), load_latest_good returned step 1")

    timing = serve_timing(program, images)
    if any(v == 0 for v in launches.values()):
        fail(f"serve: a kernel of the path never launched in phase 6: {launches}")
    print(f"phase 6: launches {launches}")
    return {"rungs": [list(r) for r in rungs], "compile_s": compile_s,
            "compute_golden_ms": golden_s * 1e3, "self_test_3_rungs_ms": selftest_ms,
            "faults": faults, "recovery": svc.stats, "disk_flip_leaf": flipped,
            "timing": timing, "launches": launches}


def serve_timing(program, images, warm: int = 2, steps: int = 10) -> dict:
    """Median ``step()`` of a service at batch 16 on the host clock, and its
    split on the device timeline by CUDA events: before ``step`` -> before
    ``execute`` (assembly + H2D copy), -> after ``execute`` was issued and
    ran (execute), -> after ``step`` returned (screen, D2H copy and the
    service's bookkeeping)."""
    def timed(prog, x, m_active):
        ev["exec0"].record()
        y = deploy.execute(prog, x, m_active)
        ev["exec1"].record()
        return y

    svc = CNNService(program, batch_size=SERVE_BATCH, execute_fn=timed)
    rows = []
    for i in range(warm + steps):
        for im in images(SERVE_BATCH):
            svc.submit(im)
        ev = {k: torch.cuda.Event(enable_timing=True)
              for k in ("start", "exec0", "exec1", "end")}
        torch.cuda.synchronize()
        ev["start"].record()
        t0 = time.perf_counter()
        done = svc.step()
        t1 = time.perf_counter()
        ev["end"].record()
        ev["end"].synchronize()
        if len(done) != SERVE_BATCH or any(r.status != "done" for r in done):
            fail(f"serve timing: step {i} served {[r.status for r in done]}")
        if i >= warm:
            rows.append({"step_ms": (t1 - t0) * 1e3,
                         "assemble_h2d_ms": ev["start"].elapsed_time(ev["exec0"]),
                         "execute_ms": ev["exec0"].elapsed_time(ev["exec1"]),
                         "screen_d2h_ms": ev["exec1"].elapsed_time(ev["end"])})
    x = svc.last_batch
    alone = loop_ms(lambda: deploy.execute(program, x))
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    out = {**med, "images_per_s": SERVE_BATCH / med["step_ms"] * 1e3,
           "execute_alone_ms": alone, "steps": rows}
    print(f"phase 6: serve at batch {SERVE_BATCH} over {steps} warm steps: median step "
          f"{med['step_ms']:.4f} ms ({out['images_per_s']:.1f} images/s); split "
          f"assembly + H2D {med['assemble_h2d_ms']:.4f} ms, execute "
          f"{med['execute_ms']:.4f} ms, screen + D2H {med['screen_d2h_ms']:.4f} ms; "
          f"execute alone {alone:.4f} ms")
    return out


LM_BATCH, LM_LEN, LM_BUCKET, LM_NEW = 8, 256, 64, 16
LM_LINEARS = {  # one weight of each LM linear shape, by its path in a layer
    "q/o 2048->2048": ("attn", "wq"), "k/v 2048->256": ("attn", "wk"),
    "gate/up 2048->16384": ("ffn", "w_gate"), "down 16384->2048": ("ffn", "w_down")}


def lm_config():
    """gemma-2b at full width and depth, fp32, M=2 binary linears."""
    return get_config("gemma_2b").replace(
        dtype="float32", quant=QuantConfig(mode="binary", M=2, K_iters=8))


def build_lm(cfg, dev, where: str = "phase 7") -> tuple[dict, dict]:
    """Phase 7: a dense LM's weights drawn on the card from a seeded
    generator, each layer binarized as soon as it is drawn (its latent
    weights freed), so gemma-2b's 7.9 GB of fp32 layer weights are never
    held at once; the embedding (and an untied head) and norms in the
    config's dtype."""
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.torch_dtype,
                                         device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = cm.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.torch_dtype,
                                              device=dev)
    layers, bin_s = [], 0.0
    for _ in range(cfg.n_layers):
        fp = tf.init_layer(gen, cfg, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        layers.append(api.binarize_model_params(cfg, fp))
        torch.cuda.synchronize()
        bin_s += time.perf_counter() - t1
        del fp
    params["layers"] = cm.stack_trees(layers)
    params["final_norm"] = cm.init_rmsnorm(cfg.d_model, cfg.torch_dtype, device=dev)
    del layers
    torch.cuda.synchronize()
    leaves = []
    cm.tree_map(leaves.append, params)
    info = {"build_s": time.perf_counter() - t0, "binarize_s": bin_s,
            "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "packed_gb": sum(t.numel() for t in leaves if t.dtype == torch.uint8) / 1e9}
    print(f"{where}: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}: built in {info['build_s']:.2f} s, of which binarize "
          f"{bin_s:.2f} s (Algorithm 2, M=2, K_iters 8); packed weights "
          f"{info['packed_gb']:.3f} GB; card memory in use {info['memory_allocated_gb']:.2f} GB "
          f"(peak {info['max_memory_allocated_gb']:.2f} GB)")
    return params, info


def lm_weight(params, name: str, layer: int = 0) -> dict:
    a, w = LM_LINEARS[name]
    return cm.tree_index(params["layers"][a][w], layer)


def lm_requests(cfg) -> list[Request]:
    """The main path's requests: prompts of 5-60 tokens from a seeded
    generator, m_active None, 1 and a per-layer schedule in turn."""
    rng = np.random.default_rng(0)
    sched = tuple(1 + (i % 2) for i in range(cfg.n_layers))
    modes = [None, 1, sched] * 3
    return [Request(prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new_tokens=LM_NEW, m_active=modes[i])
            for i, n in enumerate(rng.integers(5, 61, LM_BATCH))]


def lm_rows(cfg, params) -> list[int]:
    """Every row count T that phase 7 gives the matmul kernel: the decode
    batch, each request's prefill bucket, the first prompt unbucketed, the
    2-layer check's 16 tokens and the timed 64-token bucket, and T = 1."""
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
    reqs = lm_requests(cfg)
    return sorted({1, LM_BATCH, 16, LM_BUCKET, reqs[0].prompt.size - 1,
                   *(srv._padded_len(r.prompt.size - 1) for r in reqs)})


def check_linear_kernels(where: str, weights: dict, rows: list, gen: torch.Generator,
                         dev) -> float:
    """The matmul kernel against its plain version for each packed linear of
    ``weights`` (name -> {B_packed, alpha}) at every row count of ``rows``,
    m_active 1 and 2; the second plan must give the same bits."""
    max_err, checks = 0.0, 0
    for name, p in weights.items():
        K, N = p["B_packed"].shape[1] * 8, p["B_packed"].shape[2]
        for T in rows:
            if ops.pick_matmul_plan(T, N) == ALT_PLAN["linear"]:
                fail(f"{where} {name} T={T}: the picked plan is the second plan")
            x = torch.randn(T, K, generator=gen).to(dev)
            for m in (1, 2):
                kw = dict(K=K, group_size=K, m_active=m)
                got = ops.binary_matmul(x, p["B_packed"], p["alpha"], **kw)
                want = kref.binary_matmul_ref(x, p["B_packed"], p["alpha"], **kw)
                alt = ops.binary_matmul(x, p["B_packed"], p["alpha"], plan=ALT_PLAN["linear"],
                                        **kw)
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                    fail(f"{where} {name} T={T} m={m}: kernel vs plain max |d| {err:.3g}")
                if not torch.equal(got, alt):
                    fail(f"{where} {name} T={T} m={m}: plans differ")
                checks += 1
    torch.cuda.synchronize()
    print(f"{where}: {checks} kernel-vs-plain checks at {len(weights)} linear shapes, T = "
          f"{rows} passed (rtol {RTOL}, atol {ATOL}), second plan bit-identical; max |d| "
          f"{max_err:.3g}")
    return max_err


def check_lm_kernels(cfg, params, gen: torch.Generator, dev) -> float:
    """Phase 7: the matmul kernel against its plain version at every LM
    linear shape and every row count of ``lm_rows``."""
    return check_linear_kernels("phase 7", {n: lm_weight(params, n) for n in LM_LINEARS},
                                lm_rows(cfg, params), gen, dev)


def top2_margin(logits: np.ndarray) -> float:
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def same_stream(where: str, a: Request, b: Request, rtol=2e-5, atol=5e-5) -> None:
    """Tokens equal and last logits allclose (the JAX serving tests'
    tolerance); a token mismatch reports the top-2 margin of the logits."""
    if a.out_tokens != b.out_tokens:
        fail(f"{where}: tokens {a.out_tokens} != {b.out_tokens}; top-2 margin of the last "
             f"logits {top2_margin(a.last_logits):.3g} / {top2_margin(b.last_logits):.3g}")
    if not np.allclose(a.last_logits, b.last_logits, rtol=rtol, atol=atol):
        fail(f"{where}: last logits max |d| {np.abs(a.last_logits - b.last_logits).max():.3g}")


def serve_lm(cfg, params, dev) -> dict:
    """Phase 7, the main path: 8 requests through ``Server`` until done.
    Launch counts are set to 0 just before each admission and each step
    and read just after; every decode group step and every bulk admission
    must launch the matmul kernel 18 x 7 times."""
    per_pass = cfg.n_layers * 7
    reqs = lm_requests(cfg)
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
    leaves = []
    cm.tree_map(leaves.append, srv.cache)
    if any(t.device.type != dev.type for t in leaves) or srv.device.type != dev.type:
        fail(f"LM serve: the server or its cache is not on {dev}")
    launches = {k: 0 for k in TPU_KERNELS}

    def counted(fn, want_passes: int, where: str):
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts["binary_matmul"] != want_passes * per_pass or \
                counts["binary_conv"] or counts["binary_dwconv"]:
            fail(f"LM serve {where}: launches {counts}, want {want_passes} x {per_pass} "
                 f"matmul launches")
        for k, v in counts.items():
            launches[k] += v

    t0 = time.perf_counter()
    for r in reqs:
        counted(lambda: srv.admit(r) or fail("LM serve: admission refused"), 1, "admit")
    rounds = 0
    while any(s is not None for s in srv.slots):
        before = srv.stats["decode_steps"]
        ops.reset_launch_counts()
        srv.step()
        torch.cuda.synchronize()
        groups = srv.stats["decode_steps"] - before
        n = ops.launch_counts()["binary_matmul"]
        if n != groups * per_pass:
            fail(f"LM serve: a round of {groups} group steps launched the matmul {n} times, "
                 f"want {groups} x {per_pass}")
        launches["binary_matmul"] += n
        rounds += 1
    serve_s = time.perf_counter() - t0
    for r in reqs:
        if not r.done or len(r.out_tokens) != LM_NEW or r.last_logits.shape != (cfg.vocab,) \
                or not np.isfinite(r.last_logits).all() \
                or not all(0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"LM serve: request of {r.prompt.size} tokens ended with {r.out_tokens}")
    print(f"phase 7: served {len(reqs)} requests (prompts {[r.prompt.size for r in reqs]}, "
          f"m_active None/1/per-layer) in {rounds} rounds, {serve_s:.2f} s; stats "
          f"{srv.stats}; configs {srv.cache_sizes()}; {per_pass} matmul launches per "
          f"admission and per decode group step")

    # a request of each mode served alone gives the stream it got in the mix
    for r in reqs[:3]:
        solo = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
        again = Request(prompt=r.prompt.copy(), max_new_tokens=LM_NEW, m_active=r.m_active)
        solo.admit(again)
        solo.run_until_done()
        same_stream(f"LM serve: m_active {r.m_active} alone vs in the mix", again, r)
    # bulk admission == token-wise admission
    streams = {}
    for mode in ("bulk", "tokenwise"):
        one = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN, prefill=mode,
                     prefill_buckets=None)
        streams[mode] = Request(prompt=reqs[0].prompt.copy(), max_new_tokens=4)
        one.admit(streams[mode])
        one.run_until_done()
    same_stream("LM serve: bulk vs token-wise admission", streams["bulk"],
                streams["tokenwise"])
    print(f"phase 7: each mode served alone gave the tokens it got in the mix; bulk "
          f"admission of {reqs[0].prompt.size} tokens gave token-wise admission's tokens "
          f"{streams['bulk'].out_tokens} and logits (rtol 2e-5, atol 5e-5)")
    return {"stats": srv.stats, "rounds": rounds, "serve_s": serve_s, "launches": launches,
            "prompt_lens": [int(r.prompt.size) for r in reqs],
            "out_tokens": [r.out_tokens for r in reqs]}


def card_vs_plain(where: str, cfg, card: dict, n_prompt: int = 16, tol: float = 1e-4) -> float:
    """The card against the plain versions: prefill of ``n_prompt`` tokens
    and 2 decode steps through the port's functions on ``card`` and on a CPU
    copy of it; logits and every float cache leaf within rtol ``tol`` /
    atol ``tol``·max|x| (integer leaves equal).  Returns the worst
    max|d|/max|x|."""
    host = cm.tree_map(lambda t: t.cpu(), card)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_prompt)).astype(np.int64))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1, 1)).astype(np.int64))
    outs = {}
    for side, p in (("card", card), ("plain", host)):
        d = p["embed"]["table"].device
        logits, cache = api.prefill(cfg, p, toks.to(d), max_len=32)
        got = [logits.cpu()]
        for i in range(2):
            pos = torch.full((1,), n_prompt + i, dtype=torch.int32, device=d)
            lg, cache = api.decode_step(cfg, p, {"tokens": steps[i].to(d), "pos": pos,
                                                 "cache": cache})
            got.append(lg.cpu())
        outs[side] = (got, [t.cpu() for t in cm.tree_leaves(cache)])
    worst = 0.0
    for what, a, b in [("logits", x, y) for x, y in zip(outs["card"][0], outs["plain"][0])] \
            + [("cache", x, y) for x, y in zip(outs["card"][1], outs["plain"][1])]:
        if not a.is_floating_point():
            if not torch.equal(a, b):
                fail(f"{where} card vs plain ({what}): integer leaves differ")
            continue
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if not torch.isfinite(a).all() or scale == 0.0 or \
                not torch.allclose(a, b, rtol=tol, atol=tol * scale):
            fail(f"{where} card vs plain ({what}): max |d| {err:.3g}, max |plain| {scale:.3g}")
    return worst


def lm_card_vs_plain(cfg, params, dev, where: str = "phase 7", tol: float = 1e-4) -> dict:
    """Phase 7: the card against the plain versions, the same weights cut to
    2 layers at full width (``cfg`` may cut more: danube's window)."""
    card = dict(params, layers=cm.tree_map(lambda t: t[:2], params["layers"]))
    worst = card_vs_plain(f"{where} {cfg.name}", cfg.replace(n_layers=2), card, tol=tol)
    print(f"{where}: {cfg.name} cut to 2 layers at full width, {cfg.dtype}, prefill of 16 "
          f"tokens + 2 decode steps: card within rtol {tol} / atol {tol}·max|x| of the plain "
          f"versions on the CPU (logits and every cache leaf); worst max|d|/max|x| {worst:.3g}")
    return {"worst_rel_err": worst, "tol": tol}


def decode_timing(where: str, cfg, params, admit_reps: int = 6) -> tuple[dict, Server]:
    """Admission of a 64-token prompt (``admit_reps`` times, the first not
    timed) and a decode step at 8 active slots (host clock and CUDA
    events); returns the numbers and the server, its 8 slots still active."""
    rng = np.random.default_rng(2)
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
    prompt = rng.integers(0, cfg.vocab, LM_BUCKET).astype(np.int32)
    admit_ms = []
    for i in range(admit_reps):
        srv.slots = [None] * LM_BATCH
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.admit(Request(prompt=prompt.copy(), max_new_tokens=LM_NEW))
        torch.cuda.synchronize()
        if i:
            admit_ms.append((time.perf_counter() - t0) * 1e3)
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
    for _ in range(LM_BATCH):
        srv.admit(Request(prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                          max_new_tokens=LM_LEN - 16))
    host_ms, dev_ms = [], []
    for i in range(12):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        srv.step()
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        if i >= 2:
            host_ms.append((t1 - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
    picks = ops.plan_pick_count()
    srv.step()
    picks = ops.plan_pick_count() - picks
    step = {"admit_64_ms": statistics.median(admit_ms), "admit_64_all_ms": admit_ms,
            "decode_step_host_ms": statistics.median(host_ms),
            "decode_step_events_ms": statistics.median(dev_ms),
            "decode_steps_host_ms": host_ms, "plan_picks_per_decode_step": picks}
    step["tokens_per_s"] = LM_BATCH / step["decode_step_host_ms"] * 1e3
    how = (f"prefill at bucket {srv._padded_len(LM_BUCKET - 1)} + scatter" if srv._bulk
           else f"{LM_BUCKET - 1} token-wise decode steps")
    print(f"{where}: admission of a {LM_BUCKET}-token prompt ({how}) median "
          f"{step['admit_64_ms']:.3f} ms; "
          f"decode step at {LM_BATCH} active slots median {step['decode_step_host_ms']:.3f} ms "
          f"host clock, {step['decode_step_events_ms']:.3f} ms CUDA events "
          f"({step['tokens_per_s']:.1f} tokens/s); {picks} plan picks per step")
    return step, srv


def lm_timing(cfg, params, gen: torch.Generator, dev, out_dir: Path) -> dict:
    """Phase 7 timings: admission of a 64-token prompt, a decode step at 8
    active slots, a profiler window of 3 decode steps, and the LM linears
    one by one (``time_lm_linears``)."""
    step, srv = decode_timing("phase 7", cfg, params)
    split = profile_decode("phase 7", cfg, srv, out_dir / "trace_gemma.json")
    return {**step, "profile": split, "linears": time_lm_linears(params, gen, dev)}


def profile_decode(where: str, cfg, srv: Server, path: Path) -> dict:
    """torch.profiler over 3 decode steps of ``srv`` (after one dropped
    warm-up step): the device split (``device_split``), the binary_matmul
    and LM-head device time, the device kernels and the host-side aten ops
    per step, and the ten kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=3, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(4):
            srv.step()
            torch.cuda.synchronize()
            prof.step()
    events = json.loads(path.read_text())["traceEvents"]
    split = device_split(events)
    mm_us = sum(us for n, us in split["device_us_by_name"].items() if "binary_matmul" in n)
    head_us = sum(e.device_time_total for e in prof.key_averages(group_by_input_shape=True)
                  if e.key == "aten::mm" and any(cfg.vocab in (s or []) for s in e.input_shapes))
    if mm_us == 0 or head_us == 0:
        fail(f"{where} LM profile: binary_matmul {mm_us} us, LM head {head_us} us")
    kernels = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    ops_ = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    split.update(binary_matmul_us_per_step=mm_us / 3, lm_head_us_per_step=head_us / 3,
                 kernels_per_step=kernels / 3, cpu_ops_per_step=ops_ / 3)
    print(f"{where}: profiler over 3 decode steps: window {split['window_us'] / 3e3:.4f} ms "
          f"per step, device busy {split['busy_us'] / 3e3:.4f} ms, idle share "
          f"{split['idle_share']:.4f}; binary_matmul {mm_us / 3e3:.4f} ms and LM head "
          f"{head_us / 3e3:.4f} ms of device time per step; {kernels / 3:.1f} device kernels "
          f"and {ops_ / 3:.1f} aten ops (nested included) per step; trace "
          f"{path.relative_to(ROOT)}")
    for name, us in list(split["device_us_by_name"].items())[:10]:
        print(f"  {us / 3e3:.5f} ms per step  {name[:110]}")
    return split


def time_linears(where: str, weights: dict, gen: torch.Generator, dev,
                 row_counts=(LM_BATCH, LM_BUCKET), dtype=torch.float32) -> list:
    """Per packed linear of ``weights`` at each of ``row_counts`` (by
    default T = 8, decode, and 64, the prefill bucket), m_active 2, x in
    ``dtype``: the kernel (through ``ops.binary_matmul``, its output cast
    to x's dtype), its plain version and ``x @ W_hat`` in x's dtype (CUDA
    graphs) and the bound (x read at its own width)."""
    rows = []
    for name, p in weights.items():
        K, N = p["B_packed"].shape[1] * 8, p["B_packed"].shape[2]
        W_hat = bz.reconstruct(bz.BinApprox(bz.unpack_bits(p["B_packed"], K), p["alpha"],
                                            K)).to(dtype)
        for T in row_counts:
            x = torch.randn(T, K, generator=gen).to(dev, dtype)
            kw = dict(K=K, group_size=K)
            ms = graph_ms(lambda: ops.binary_matmul(x, p["B_packed"], p["alpha"], **kw))
            plain_ms = graph_ms(lambda: kref.binary_matmul_ref(x, p["B_packed"], p["alpha"],
                                                               **kw), reps=3)
            lib_ms = graph_ms(lambda: x @ W_hat)
            nbytes = (x.element_size() * T * K + p["B_packed"].numel()
                      + 4 * p["alpha"].numel() + 4 * T * N)
            flops = 2 * T * K * N
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
            rows.append({"shape": name, "T": T, "K": K, "N": N, "x_dtype": str(dtype),
                         "plan": list(ops.pick_matmul_plan(T, N)), "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                         "bytes": nbytes, "flops": flops})
            print(f"  {where} {name} T={T} x {dtype} plan {tuple(rows[-1]['plan'])}: kernel "
                  f"{ms:.5f} ms, "
                  f"plain {plain_ms:.5f} ms, x @ W_hat {lib_ms:.5f} ms, bound "
                  f"{rows[-1]['bound_ms']:.5f} ms ({rows[-1]['bound_by']})")
        del W_hat
    return rows


def time_lm_linears(params, gen: torch.Generator, dev) -> list:
    """Phase 7's LM linear shapes through ``time_linears``."""
    return time_linears("LM", {n: lm_weight(params, n) for n in LM_LINEARS}, gen, dev)


def lm_phase(gen: torch.Generator, dev, out_dir: Path) -> dict:
    """Phase 7: gemma-2b on the card through the port's LM stack and Server
    (7a, fp32), then the dense LMs in their own dtype (7b-7d)."""
    cfg = lm_config()
    t0 = time.time()
    params, build = build_lm(cfg, dev)
    max_err = check_lm_kernels(cfg, params, gen, dev)
    served = serve_lm(cfg, params, dev)
    plain = lm_card_vs_plain(cfg, params, dev)
    timing = lm_timing(cfg, params, gen, dev, out_dir)
    print(f"phase 7a: {time.time() - t0:.1f} s")
    t1 = time.time()
    bf16 = {"gemma_2b": gemma_bf16(cfg, params, gen, dev, timing, out_dir)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    bf16["h2o_danube_1_8b"] = danube_ring(gen, dev)
    for name in DENSE_CUT:
        bf16[name] = dense_cut(name, gen, dev)
    launches = {k: sum(r["launches"][k] for r in bf16.values()) for k in TPU_KERNELS}
    print(f"phase 7b-7d: {time.time() - t1:.1f} s; launches {launches}")
    print(f"phase 7: {time.time() - t0:.1f} s")
    return {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype, "M": 2},
            "build": build, "max_abs_err": max_err, "serve": served, "card_vs_plain": plain, "timing": timing,
            "bf16": bf16, "bf16_launches": launches}


# ---------------------------------------------------------------------------
# Phase 7b-7d: the dense LMs in their own dtype (bf16), packed M=2 linears
# on the kernel, which reads the bf16 rows as they are
# ---------------------------------------------------------------------------

LM_BF16_TOL = 2e-2    # bf16 logits and caches: rtol and atol·max|x| (MESH_LM_BF16_RTOL's)
RING_PROMPT, RING_DECODES = 4200, 8     # 7c: a prompt past danube's 4096-token window
RING_CPU_WINDOW = 16                    # 7c's card vs plain: a 16-token prompt fills the ring
DENSE_CUT = {"qwen3_14b": 4, "codeqwen15_7b": 4}    # 7d: depth 40 / 32 cut to 4 (time)


def dense_bf16_config(name: str, n_layers: int | None = None):
    """``name`` at published width in its own dtype (bf16), M=2 binary
    linears (K_iters 8); ``n_layers`` cuts the depth."""
    cfg = get_config(name).replace(quant=QuantConfig(mode="binary", M=2, K_iters=8))
    return cfg if n_layers is None else cfg.replace(n_layers=n_layers)


def dense_weights(params) -> dict:
    """One packed linear of each shape of a dense LM's layer 0."""
    return {f"{a}/{w}": cm.tree_index(params["layers"][a][w], 0)
            for a, ws in (("attn", ("wq", "wk", "wv", "wo")),
                          ("ffn", ("w_gate", "w_up", "w_down")))
            for w in ws}


@contextlib.contextmanager
def kernel_x_dtypes(seen: list):
    """``binary_matmul.launch`` recording the dtype of each launch's x."""
    real = bmk.launch

    def rec(x, *args, **kw):
        seen.append(x.dtype)
        return real(x, *args, **kw)
    bmk.launch = rec
    try:
        yield
    finally:
        bmk.launch = real


class AtenOps(TorchDispatchMode):
    """The aten ops dispatched while it is active, each with its tensor
    inputs' dtypes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append((func._overloadpacket.__name__,
                         [a.dtype for a in args if isinstance(a, torch.Tensor)]))
        return func(*args, **(kwargs or {}))


VIEW_OPS = {"view", "_reshape_alias", "reshape", "_unsafe_view", "as_strided", "alias",
            "detach", "expand", "slice", "select", "t", "transpose", "unsqueeze", "squeeze"}


def bf16_x_checks(where: str, weights: dict, rows: list, gen: torch.Generator, dev) -> int:
    """The matmul kernel on bf16 x: its fp32 output ``torch.equal`` to the
    same launch on ``x.float()`` at each linear of ``weights``, each row
    count of ``rows``, m_active 1 and 2, at the picked plan and the second
    one; and ``ops.binary_matmul`` on bf16 x copies no x (no aten op but a
    view reads a bf16 tensor) and returns bf16.  Returns the checks."""
    checks = 0
    for name, p in weights.items():
        K, N = p["B_packed"].shape[1] * 8, p["B_packed"].shape[2]
        for T in rows:
            xb = torch.randn(T, K, generator=gen).to(dev, torch.bfloat16)
            for m in (1, 2):
                for plan in (ops.pick_matmul_plan(T, N), ALT_PLAN["linear"]):
                    kw = dict(K=K, group_size=K, m_active=m, plan=plan)
                    got = bmk.launch(xb, p["B_packed"], p["alpha"], **kw)
                    want = bmk.launch(xb.float(), p["B_packed"], p["alpha"], **kw)
                    if not torch.equal(got, want):
                        fail(f"{where} {name} T={T} m={m} plan {plan}: bf16 x differs from "
                             f"x.float() (max |d| {float((got - want).abs().max()):.3g})")
                    checks += 1
        rec = AtenOps()
        with rec:
            y = ops.binary_matmul(xb, p["B_packed"], p["alpha"], K=K, group_size=K)
        copies = [op for op, dts in rec.ops if torch.bfloat16 in dts and op not in VIEW_OPS]
        if copies or y.dtype != torch.bfloat16:
            fail(f"{where} {name}: ops.binary_matmul on bf16 x ran {copies} on it, "
                 f"returned {y.dtype}")
    # an odd K, and an x two bytes off a 4-byte boundary: read element by
    # element, not two per 32-bit load
    for K, off in ((1001, 0), (2048, 1)):
        flat = torch.randn(8 * K + 1, generator=gen).to(dev, torch.bfloat16)
        xb = flat[off: off + 8 * K].view(8, K)
        signs = torch.randint(0, 2, (2, K, 96), generator=gen, dtype=torch.int8) * 2 - 1
        bp = bz.pack_bits(bz.pad_rows_to_byte(signs)).to(dev)
        al = torch.rand(2, 1, 96, generator=gen).to(dev) / K ** 0.5
        for plan in ((1, 32), ALT_PLAN["linear"], (8, 32)):
            kw = dict(K=K, group_size=K, m_active=2, plan=plan)
            if not torch.equal(bmk.launch(xb, bp, al, **kw), bmk.launch(xb.float(), bp, al, **kw)):
                fail(f"{where}: bf16 x at K={K}, offset {off} differs from x.float() at {plan}")
            checks += 1
    torch.cuda.synchronize()
    print(f"{where}: {checks} bf16-x launches torch.equal to the same launches on x.float() "
          f"({len(weights)} linear shapes, T = {rows}, m_active 1 and 2, both plans; K = 1001 "
          f"and an x off a 4-byte boundary, read by elements); ops.binary_matmul reads bf16 x "
          f"with no cast (its aten ops on x: views only)")
    return checks


def served_bf16(where: str, cfg, params, per_pass: int) -> dict:
    """``serve_twice`` (phase 7's requests at 8 slots, ``per_pass`` matmul
    launches per admission and per decode group step, a second run
    bit-equal) with every launch's x recorded: all bf16."""
    seen = []
    with kernel_x_dtypes(seen):
        reqs, srv, rounds, launches, serve_s = serve_twice(where, cfg, params, per_pass)
    n = launches["binary_matmul"]
    if len(seen) != 2 * n or set(seen) != {torch.bfloat16}:
        fail(f"{where} {cfg.name}: {len(seen)} launches over the two runs (want 2 x {n}), "
             f"x dtypes {set(seen)}")
    print(f"phase {where}: {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}) served "
          f"{len(reqs)} requests in {rounds} rounds, {serve_s:.2f} s; {per_pass} matmul launches "
          f"per admission and per decode group step, every one on bf16 x; a second run gave the "
          f"same tokens and bit-equal logits")
    return {"stats": srv.stats, "rounds": rounds, "serve_s": serve_s, "launches": launches,
            "per_pass": per_pass, "out_tokens": [r.out_tokens for r in reqs]}


def bulk_vs_tokenwise_bf16(where: str, cfg, params, prompt: np.ndarray) -> float:
    """Admission of ``prompt`` and the decode step that reads its last token,
    bulk and token-wise: the logits and slot 0's cache within the bf16
    tolerance; returns the worst max|d|/max|x|."""
    sides = {}
    for mode in ("bulk", "tokenwise"):
        srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN, prefill=mode,
                     prefill_buckets=None)
        r = Request(prompt=prompt.copy(), max_new_tokens=1)
        srv.admit(r)
        srv.step()
        sides[mode] = [torch.from_numpy(r.last_logits)] + [
            t[:, 0].cpu() for t in cm.tree_leaves(srv.cache)]
    worst = 0.0
    for i, (a, b) in enumerate(zip(sides["bulk"], sides["tokenwise"])):
        if a.is_floating_point():
            worst = max(worst, close_to(f"{where} bulk vs token-wise ({'logits' if i == 0 else 'cache'})",
                                        a, b, LM_BF16_TOL))
        elif not torch.equal(a, b):
            fail(f"{where} bulk vs token-wise: integer cache leaves differ")
    print(f"phase {where}: {cfg.name} bulk admission of {prompt.size} tokens vs token-wise: "
          f"logits and slot 0's cache within rtol {LM_BF16_TOL} / atol {LM_BF16_TOL}·max|x|; "
          f"worst max|d|/max|x| {worst:.3g}")
    return worst


def gemma_bf16(cfg, params, gen: torch.Generator, dev, fp32: dict, out_dir: Path) -> dict:
    """Phase 7b: phase 7's packed gemma-2b (all 18 layers) in bf16: the
    embedding and norms cast, the packed bits and fp32 alphas kept."""
    t0 = time.time()
    cfg16, p16 = bf16_tree(cfg, params)
    weights = {n: lm_weight(p16, n) for n in LM_LINEARS}
    rows = lm_rows(cfg16, p16)
    checks = bf16_x_checks("phase 7b", weights, rows, gen, dev)
    served = served_bf16("7b", cfg16, p16, cfg.n_layers * 7)
    bulk = bulk_vs_tokenwise_bf16("7b", cfg16, p16, lm_requests(cfg16)[0].prompt)
    plain = lm_card_vs_plain(cfg16, p16, dev, "phase 7b", LM_BF16_TOL)
    step, srv = decode_timing("phase 7b", cfg16, p16)
    step["profile"] = profile_decode("phase 7b", cfg16, srv, out_dir / "trace_gemma_bf16.json")
    del srv
    p, q = step["profile"], fp32["profile"]
    print(f"phase 7b: bf16 beside phase 7's fp32 in this run: admission of {LM_BUCKET} tokens "
          f"{step['admit_64_ms']:.3f} vs {fp32['admit_64_ms']:.3f} ms, decode step at "
          f"{LM_BATCH} slots {step['decode_step_host_ms']:.3f} vs "
          f"{fp32['decode_step_host_ms']:.3f} ms host clock; per step "
          f"{p['kernels_per_step']:.1f} vs {q['kernels_per_step']:.1f} device kernels, "
          f"{p['cpu_ops_per_step']:.1f} vs {q['cpu_ops_per_step']:.1f} aten ops, binary_matmul "
          f"{p['binary_matmul_us_per_step'] / 1e3:.4f} vs "
          f"{q['binary_matmul_us_per_step'] / 1e3:.4f} ms of device time")
    linears = time_linears("7b", weights, gen, dev, dtype=torch.bfloat16)
    launch_ms = time_launches("7b", weights, gen, dev)
    print(f"phase 7b: {time.time() - t0:.1f} s")
    return {"bf16_x_checks": checks, "serve": served,
            "launches": served["launches"], "bulk_vs_tokenwise": bulk,
            "card_vs_plain": plain, "timing": step, "linears": linears,
            "launch_ms": launch_ms, "seconds": time.time() - t0}


def time_launches(where: str, weights: dict, gen: torch.Generator, dev,
                  row_counts=(LM_BATCH, LM_BUCKET)) -> list:
    """At each linear of ``weights`` and each of ``row_counts``, m_active 2:
    the launcher alone (no wrapper, no cast of x or of y) on bf16 x and on
    an fp32 copy of it, and the two routes a bf16 model's linear can take:
    the kernel reading bf16 x (``ops.binary_matmul``: the launch, then y
    cast to bf16) and the route before the kernel read bf16 (x cast to
    fp32, the fp32 launch, y cast to bf16).  Each in CUDA graphs (device
    time) and issued from the host (``loop_ms``: host work included), in
    the order a, b, b, a."""
    rows = []
    for name, p in weights.items():
        K = p["B_packed"].shape[1] * 8
        for T in row_counts:
            xb = torch.randn(T, K, generator=gen).to(dev, torch.bfloat16)
            xf = xb.float()
            kw = dict(K=K, group_size=K, m_active=2,
                      plan=ops.pick_matmul_plan(T, p["B_packed"].shape[2]))
            fns = {"bf16": lambda: bmk.launch(xb, p["B_packed"], p["alpha"], **kw),
                   "fp32": lambda: bmk.launch(xf, p["B_packed"], p["alpha"], **kw),
                   "route_bf16": lambda: ops.binary_matmul(xb, p["B_packed"], p["alpha"],
                                                           K=K, group_size=K),
                   "route_cast": lambda: bmk.launch(xb.float(), p["B_packed"], p["alpha"],
                                                    **kw).to(torch.bfloat16)}
            if not torch.equal(fns["route_bf16"](), fns["route_cast"]()):
                fail(f"{where} {name} T={T}: the two bf16 routes differ")
            ms = {}
            for a, b in (("bf16", "fp32"), ("route_bf16", "route_cast")):
                for key in (a, b, b, a):
                    ms.setdefault(f"{key}_ms", []).append(graph_ms(fns[key]))
                for key in (a, b, b, a):
                    ms.setdefault(f"{key}_host_ms", []).append(loop_ms(fns[key], reps=50))
            rows.append({"shape": name, "T": T, **ms})
            f = lambda k: " / ".join(f"{v:.5f}" for v in ms[k])  # noqa: E731
            print(f"  {where} {name} T={T}: launcher alone bf16 x {f('bf16_ms')} ms, fp32 x "
                  f"{f('fp32_ms')} ms; route bf16 x {f('route_bf16_ms')} ms, cast route "
                  f"{f('route_cast_ms')} ms (graphs); from the host: route bf16 x "
                  f"{f('route_bf16_host_ms')} ms, cast route {f('route_cast_host_ms')} ms")
    return rows


def danube_ring(gen: torch.Generator, dev) -> dict:
    """Phase 7c: h2o-danube-1.8b, 24 layers at full width, bf16, its
    published 4096-token window: one request whose prompt (4200 tokens)
    wraps the ring, admitted in bulk and decoded 8 tokens (24 x 7 matmul
    launches per pass), each step's logits within the bf16 tolerance of
    the teacher-forced forward over the same tokens with the sliding mask;
    the kernel's bf16 checks at its linear shapes; 2 layers with the window
    cut to 16 against the plain versions on the CPU."""
    t0 = time.time()
    cfg = dense_bf16_config("h2o_danube_1_8b")
    params, build = build_lm(cfg, dev, "phase 7c")
    weights = dense_weights(params)
    checks = bf16_x_checks("phase 7c", weights, [1, LM_BATCH, 16, LM_BUCKET], gen, dev)
    per_pass = cfg.n_layers * 7
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, RING_PROMPT).astype(np.int32)
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=RING_PROMPT + RING_DECODES + 1)
    r = Request(prompt=prompt, max_new_tokens=RING_DECODES)
    seen, logits, launches = [], [], {k: 0 for k in TPU_KERNELS}
    with kernel_x_dtypes(seen):
        _, n = counted_step(lambda: srv.admit(r) or fail("7c: admission refused"))
        passes = [n]
        while not r.done:
            _, n = counted_step(srv.step)
            passes.append(n)
            logits.append(torch.from_numpy(r.last_logits))
    if passes != [per_pass] * (RING_DECODES + 1) or set(seen) != {torch.bfloat16} \
            or srv.stats["bulk_prefills"] != 1:
        fail(f"7c: matmul launches per pass {passes} (want {per_pass} each), x dtypes "
             f"{set(seen)}, stats {srv.stats}")
    launches["binary_matmul"] = sum(passes)
    ring = cm.tree_leaves(srv.cache)
    window = ring[0].shape[2] if ring else 0
    toks = np.concatenate([prompt, np.asarray(r.out_tokens[:-1], np.int32)])
    with torch.no_grad():
        full, _ = api.forward(cfg, params, {"tokens": torch.from_numpy(toks)[None].to(dev)})
    want = full[0, RING_PROMPT - 1:].float().cpu()
    del full
    worst = close_to("7c decode vs the teacher-forced forward", torch.stack(logits), want,
                     LM_BF16_TOL)
    print(f"phase 7c: {cfg.name} (window {cfg.sliding_window}, ring of {window} rows): a "
          f"{RING_PROMPT}-token prompt admitted in bulk and {RING_DECODES} tokens decoded "
          f"({per_pass} matmul launches per pass, every one on bf16 x), each step's logits "
          f"within rtol {LM_BF16_TOL} / atol {LM_BF16_TOL}·max|x| of the teacher-forced forward "
          f"over the same {toks.size} tokens; worst max|d|/max|x| {worst:.3g}")
    plain = lm_card_vs_plain(cfg.replace(sliding_window=RING_CPU_WINDOW), params, dev,
                             "phase 7c", LM_BF16_TOL)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 7c: {time.time() - t0:.1f} s")
    return {"build": build, "bf16_x_checks": checks, "launches": launches,
            "ring_rows": window, "decode_vs_forward": worst, "out_tokens": r.out_tokens,
            "card_vs_plain": plain, "seconds": time.time() - t0}


def dense_cut(name: str, gen: torch.Generator, dev) -> dict:
    """Phase 7d: ``name`` (qwen3-14b: qk-norm; codeqwen1.5-7b: qkv_bias) at
    full width, bf16, cut to ``DENSE_CUT[name]`` layers: the kernel's bf16
    checks at its linear shapes, phase 7's requests served at 8 slots with
    launch counts, 2 layers against the plain versions on the CPU."""
    t0 = time.time()
    cfg = dense_bf16_config(name, DENSE_CUT[name])
    params, build = build_lm(cfg, dev, "phase 7d")
    checks = bf16_x_checks("phase 7d", dense_weights(params), [1, LM_BATCH, 16, LM_BUCKET],
                           gen, dev)
    served = served_bf16("7d", cfg, params, cfg.n_layers * 7)
    plain = lm_card_vs_plain(cfg, params, dev, "phase 7d", LM_BF16_TOL)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 7d: {cfg.name}: {time.time() - t0:.1f} s")
    return {"build": build, "bf16_x_checks": checks, "serve": served,
            "launches": served["launches"], "card_vs_plain": plain,
            "seconds": time.time() - t0}


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 3     # phase 8b: 1 warm step, 2 timed


def last_vs_first(where: str, losses: list, n: int = 20) -> tuple[float, float]:
    """Mean of the first and the last ``n`` losses; fails unless it fell."""
    first, last = statistics.mean(losses[:n]), statistics.mean(losses[-n:])
    if not last < first:
        fail(f"{where}: mean loss of the last {n} steps {last:.4f} is not below that of "
             f"the first {n}, {first:.4f}")
    return first, last


def train_cnn_a(dev) -> dict:
    """Phase 8a: the paper's Table II pipeline on CNN-A at full width
    (``tools/torch_train_cnn_a.py``): fp32 training, Algorithm 2, STE
    retraining, then ``deploy.execute`` of the retrained network on the
    ``binary_conv`` and ``binary_matmul`` kernels (counts reset just before
    that call, read just after)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_train_cnn_a as table2_tool

    t0 = time.time()
    out = table2_tool.table2(steps=300, M=2, eval_n=512, batch=64, device=dev)
    fp = last_vs_first("8a fp32 training", out["fp_losses"])
    rt = last_vs_first("8a STE retraining", out["rt_losses"])
    want, got = out["logits_fake_quant"], out["logits_deploy"]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or not torch.allclose(got, want, rtol=1e-4,
                                                                 atol=1e-4 * scale):
        fail(f"8a: execute's logits vs the fake-quant forward max |d| {err:.3g} "
             f"(max |logit| {scale:.3g})")
    if abs(out["acc_deploy"] - out["acc_rt"]) > 0.02:
        fail(f"8a: deployed accuracy {out['acc_deploy']:.4f} is not within 0.02 of the "
             f"retrained fake-quant accuracy {out['acc_rt']:.4f}")
    if out["launches"] != EXPECTED_LAUNCHES["cnn_a"]:
        fail(f"8a: execute launched {out['launches']}, not {EXPECTED_LAUNCHES['cnn_a']}")
    # Algorithm 2 alone over the five layers, as one fake-quant forward runs it
    alg2 = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for spec in cnn.CNN_A_SPECS:
            w = out["params_rt"][spec.name]["w"]
            with torch.no_grad():
                bz.reconstruct(bz.algorithm2(w.reshape(-1, w.shape[-1]), 2, K_iters=25))
        torch.cuda.synchronize()
        alg2.append(time.perf_counter() - t1)
    res = {k: out[k] for k in ("acc_fp", "acc_bin", "acc_rt", "acc_deploy", "compression",
                               "eq6", "fp_step_ms", "rt_step_ms", "compile_s", "launches")}
    res.update(fp_loss_first_last=fp, rt_loss_first_last=rt, logits_max_abs_err=err,
               max_abs_logit=scale, algorithm2_ms=1e3 * statistics.median(alg2),
               seconds=time.time() - t0)
    print(f"phase 8a: CNN-A Table II on the card: accuracy fp32 {out['acc_fp']:.4f}, "
          f"binarized (Algorithm 2, M=2) {out['acc_bin']:.4f}, retrained {out['acc_rt']:.4f}, "
          f"deployed {out['acc_deploy']:.4f}; compression {out['compression']:.2f}x; mean "
          f"loss first/last 20 steps {fp[0]:.4f}/{fp[1]:.4f} (fp32), {rt[0]:.4f}/{rt[1]:.4f} "
          f"(STE); median step {out['fp_step_ms']:.3f} ms fp32, {out['rt_step_ms']:.3f} ms "
          f"fake-quant, of which Algorithm 2 alone {res['algorithm2_ms']:.3f} ms; execute vs "
          f"fake-quant max |d| {err:.3g} (max |logit| {scale:.4g}); "
          f"launches {out['launches']}; {res['seconds']:.1f} s")
    return res


def train_lm_config():
    """gemma-2b at full width and depth in its own dtype (bf16) and remat,
    fake-quant binary linears, M=2, K_iters 8."""
    cfg = get_config("gemma_2b")
    return cfg.replace(quant=QuantConfig(mode="fake_quant", M=2, K_iters=8))


def train_gemma(dev) -> dict:
    """Phase 8b: three ``build_train_step`` steps of gemma-2b at full width
    (1 warm, 2 timed), every loss finite, every leaf's moments moved; the
    params' changes, Algorithm 2's share of a step and the peak memory."""
    cfg = train_lm_config()
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw(warmup_cosine(3e-4, 10, TRAIN_STEPS))
    state = train_steps.init_train_state(cfg, opt, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in cm.tree_leaves(state["params"]))
    before = [t.to("cpu", copy=True) for t in cm.tree_leaves(state["params"])]
    step_fn = train_steps.build_train_step(cfg, opt)
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=dev)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        batch = data.next_batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
        if metrics["skipped"] or not math.isfinite(losses[-1]):
            fail(f"8b: step {len(losses) - 1} loss {losses[-1]} is not finite")
    peak = torch.cuda.max_memory_allocated()
    changed = {}
    paths = param_paths(state["params"])
    for path, old, new, mu in zip(paths, before, cm.tree_leaves(state["params"]),
                                  cm.tree_leaves(state["opt_state"]["mu"])):
        if not bool(torch.isfinite(mu).all()) or not bool((mu != 0).any()):
            fail(f"8b: the moments of {path} did not move (no gradient reached it)")
        changed[path] = float((new.cpu() != old).float().mean())
    frozen = [p for p, f in changed.items() if f == 0.0]
    if [p for p in frozen if not p.endswith("scale")]:
        fail(f"8b: these weight leaves did not change: {frozen}")
    # Algorithm 2 alone over the 126 binary linears (one forward's worth)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_lin = 0
    for path, leaf in zip(paths, cm.tree_leaves(state["params"])):
        if leaf.ndim == 3:
            for w in leaf:
                with torch.no_grad():
                    bz.reconstruct(bz.algorithm2(w.to(torch.float32), 2, K_iters=8))
                n_lin += 1
    torch.cuda.synchronize()
    alg2_s = time.perf_counter() - t1
    step_ms = 1e3 * statistics.median(step_s[1:])
    res = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
                      "remat": cfg.remat, "M": 2, "K_iters": 8, "batch": TRAIN_BATCH,
                      "seq": TRAIN_SEQ},
           "n_params": n_params, "init_s": init_s, "losses": losses,
           "step_ms": [1e3 * s for s in step_s], "median_step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "algorithm2_linears": n_lin, "algorithm2_s": alg2_s,
           "algorithm2_share": 2 * alg2_s / (step_ms / 1e3),
           "max_memory_allocated_gb": peak / 1e9, "changed_fraction": changed,
           "unchanged_leaves": frozen, "seconds": time.time() - t0}
    print(f"phase 8b: gemma-2b {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}, remat {cfg.remat}, fake-quant M=2: {n_params} "
          f"params, state built in {init_s:.1f} s; losses {[round(x, 4) for x in losses]}; "
          f"median step {step_ms:.1f} ms ({res['tokens_per_s']:.1f} tokens/s) of "
          f"{[round(1e3 * s, 1) for s in step_s]} ms; Algorithm 2 alone over {n_lin} linears "
          f"{alg2_s:.3f} s, twice per step under remat = {res['algorithm2_share']:.3f} of a "
          f"step; max_memory_allocated {peak / 1e9:.2f} GB; leaves unchanged in bf16 "
          f"{frozen}; {res['seconds']:.1f} s")
    return res


def param_paths(tree, prefix="") -> list:
    """'/'-joined paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in param_paths(tree[k], f"{prefix}/{k}")]
    return [prefix.lstrip("/")]


@contextlib.contextmanager
def nan_on_call(n: int):
    """``api.loss_fn`` returns a non-finite loss on its n-th call (the
    injected fault of phase 8c), the real one before and after."""
    real, calls = api.loss_fn, {"n": 0}

    def patched(cfg, params, batch):
        loss, metrics = real(cfg, params, batch)
        calls["n"] += 1
        if calls["n"] == n:
            loss = loss * float("nan")
            metrics = dict(metrics, loss=loss)
        return loss, metrics

    api.loss_fn = patched
    try:
        yield
    finally:
        api.loss_fn = real


def train_resume(dev, out_dir: Path) -> dict:
    """Phase 8c: ``Trainer`` on the card at reduced(gemma_2b), fp32, with
    deterministic algorithms: 10 steps checkpointed at 5 and 10; a run killed
    at 5 and resumed by a fresh Trainer ends with the same embedding table
    (torch.equal); one injected non-finite loss is skipped and counted."""
    cfg = reduced(get_config("gemma_2b")).replace(dtype="float32")
    root = out_dir / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()

    def trainer(name: str, total: int) -> Trainer:
        opt = adamw(1e-3)
        return Trainer(train_steps.build_train_step(cfg, opt),
                       train_steps.init_train_state(cfg, opt, device=dev),
                       SyntheticTokens(cfg.vocab, 16, 4, seed=0, device=dev),
                       TrainerConfig(total_steps=total, checkpoint_every=5,
                                     checkpoint_dir=str(root / name), log_every=100))

    torch.use_deterministic_algorithms(True)
    try:
        full = trainer("full", 10)
        full.run()
        trainer("killed", 5).run()
        resumed = trainer("killed", 10)
        if not resumed.maybe_resume() or resumed.report.resumed_from != 5:
            fail(f"8c: no resume from step 5 (resumed_from {resumed.report.resumed_from})")
        resumed.run()
        a, b = full.state["params"]["embed"]["table"], resumed.state["params"]["embed"]["table"]
        if not torch.equal(a, b):
            fail(f"8c: the resumed run's embedding table differs, max |d| "
                 f"{float((a - b).abs().max()):.3g}")
        guarded = trainer("nan", 3)
        with nan_on_call(2):
            report = guarded.run()
        if report.nan_skips != 1 or int(guarded.state["step"]) != 2:
            fail(f"8c: nan_skips {report.nan_skips}, step {int(guarded.state['step'])} "
                 "(want 1 and 2)")
    finally:
        torch.use_deterministic_algorithms(False)
    res = {"losses": full.report.losses, "resumed_losses": resumed.report.losses,
           "nan_skips": report.nan_skips, "seconds": time.time() - t0}
    print(f"phase 8c: Trainer on the card (reduced gemma-2b, fp32, deterministic): 10 steps, "
          f"loss {full.report.losses[0]:.4f} -> {full.report.losses[-1]:.4f}; killed at 5 and "
          f"resumed: embedding table torch.equal; one injected NaN skipped (nan_skips "
          f"{report.nan_skips}); {res['seconds']:.1f} s")
    return res


TRAIN_WIDE = ("whisper_medium", "internvl2_2b")    # phase 8d


def train_wide(name: str, dev) -> dict:
    """Phase 8d: ``name`` at published width and depth in its own dtype
    (bf16) with remat, fake-quant M=2 (K_iters 8), phase 8b's optimizer and
    batch (8 x 64 tokens) with random frame or patch embeddings, as the stub
    frontends take them: one ``build_train_step`` step; the whole state
    (params, both moments, the step) copied to the host, dropped from the
    card and restored from that copy; a second step by a fresh step
    function from the restored state.  Gates (8b's): both losses finite and
    no NaN skip, every leaf's moments moved, every weight leaf changed (a
    norm scale at 1.0 does not move in bf16 at this warmup's lr); the
    steps' ms and the peak memory."""
    cfg = get_config(name).replace(quant=QuantConfig(mode="fake_quant", M=2, K_iters=8))
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw(warmup_cosine(3e-4, 10, 2))
    state = train_steps.init_train_state(cfg, opt, device=dev)
    n_params = sum(t.numel() for t in cm.tree_leaves(state["params"]))
    before = [t.to("cpu", copy=True) for t in cm.tree_leaves(state["params"])]
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    key, n = (("frame_embeds", cfg.encoder_len) if cfg.family == "encdec"
              else ("patch_embeds", cfg.n_image_tokens))
    losses, step_ms, restore_s = [], [], 0.0
    for i in range(2):
        if i:       # the resume: the whole state through host memory and back
            t1 = time.perf_counter()
            host = cm.tree_map(lambda t: t.to("cpu", copy=True), state)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            state = cm.tree_map(lambda t: t.to(dev), host)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t1
            if int(state["step"]) != 1:
                fail(f"8d {name}: the restored state is at step {int(state['step'])}")
            del host
        batch = dict(data.next_batch())
        batch[key] = torch.randn((TRAIN_BATCH, n, cfg.d_model), generator=gen,
                                 device=dev).to(cfg.torch_dtype)
        step_fn = train_steps.build_train_step(cfg, opt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        losses.append(float(metrics["loss"]))
        if metrics["skipped"] or not math.isfinite(losses[-1]):
            fail(f"8d {name}: step {i + 1} loss {losses[-1]}, skipped {metrics['skipped']}")
    peak = torch.cuda.max_memory_allocated()
    paths = param_paths(state["params"])
    changed = {}
    for path, old, new, mu in zip(paths, before, cm.tree_leaves(state["params"]),
                                  cm.tree_leaves(state["opt_state"]["mu"])):
        if not bool(torch.isfinite(mu).all()) or not bool((mu != 0).any()):
            fail(f"8d {name}: the moments of {path} did not move (no gradient reached it)")
        changed[path] = float((new.cpu() != old).float().mean())
    frozen = [q for q, f in changed.items() if f == 0.0]
    if [q for q in frozen if not q.endswith("scale")]:
        fail(f"8d {name}: these weight leaves did not change: {frozen}")
    res = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                      "n_encoder_layers": cfg.n_encoder_layers, "d_model": cfg.d_model,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
                      "remat": cfg.remat, "M": 2, "K_iters": 8, "batch": TRAIN_BATCH,
                      "seq": TRAIN_SEQ, key: n},
           "n_params": n_params, "losses": losses, "step_ms": step_ms,
           "restore_s": restore_s, "max_memory_allocated_gb": peak / 1e9,
           "unchanged_leaves": frozen, "seconds": time.time() - t0}
    print(f"phase 8d: {cfg.name} ({cfg.n_layers} layers"
          + (f" + {cfg.n_encoder_layers} encoder layers" if cfg.n_encoder_layers else "")
          + f", d_model {cfg.d_model}, {cfg.dtype}, remat {cfg.remat}, fake-quant M=2, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens + {n} {key}): {n_params} params; losses "
          f"{[round(x, 4) for x in losses]}; step {step_ms[0]:.1f} ms, resumed step "
          f"{step_ms[1]:.1f} ms after a {restore_s:.2f} s round trip of the whole state "
          f"through host memory; every leaf's moments moved; max_memory_allocated "
          f"{peak / 1e9:.2f} GB; leaves unchanged in bf16 {frozen}; {res['seconds']:.1f} s")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_phase(dev, out_dir: Path) -> dict:
    """Phase 8: training on the card (8a CNN-A, 8b gemma-2b, 8c Trainer,
    8d whisper-medium and internvl2-2b)."""
    t0 = time.time()
    cnn_a = train_cnn_a(dev)
    gemma = train_gemma(dev)
    gc.collect()
    torch.cuda.empty_cache()
    resume = train_resume(dev, out_dir)
    wide = {name: train_wide(name, dev) for name in TRAIN_WIDE}
    print(f"phase 8: {time.time() - t0:.1f} s")
    return {"cnn_a": cnn_a, "gemma": gemma, "trainer": resume, "wide": wide}


# ---------------------------------------------------------------------------
# Phase 9: the verification tier
# ---------------------------------------------------------------------------

FUZZ_SEEDS = range(128)        # include the JAX package's pinned 0, 3, 6, 11
MOBILENET_B2 = {"width_mult": 1.0, "n_classes": 1000, "resolution": 224}
SOAK_STEPS = {"executor": 520, "cnn_server": 324, "checkpoint": 120, "server": 1100}
SOAK_FAMILIES = ("h2o_danube_1_8b", "qwen3_14b", "codeqwen15_7b")
FAMILY_STEPS, PARITY_ROUNDS = 100, 4


def counted_launches(fn, into: dict):
    """Run ``fn`` with every launch count set to 0 just before it and add
    the counts read just after into ``into``."""
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    for k, v in ops.launch_counts().items():
        into[k] += v
    return out


def fuzz_phase(dev) -> dict:
    """Phase 9a: random networks through the three kernels.  Each seed's
    network is compiled on the card and verified (zero ERRORs), then
    ``execute`` at its execute batch, m_active None and 1 (the counted main
    path, one launch per instruction), is held torch.equal to the per-call
    kernel path (``fuzz.kernel_forward``: each layer with its own plan pick)
    and within rtol 1e-4 / atol 1e-4·max|logit| of ``execute_reference``."""
    t0 = time.time()
    launches = {k: 0 for k in TPU_KERNELS}
    covered = {f: [] for f in fuzz.FEATURES}
    worst = 0.0
    for seed in FUZZ_SEEDS:
        net = fuzz.random_network(seed)
        where = f"9a: seed {seed} ({[s.name for s in net.specs]} @ {net.input_shape}, " \
                f"exec batch {net.exec_batch}, M {net.M})"
        qc = QuantConfig(mode="binary", M=net.M, K_iters=2)
        packed = cnn.spec_binarize(
            net.specs, net.init_params(torch.Generator().manual_seed(seed), device=dev), qc)
        prog = deploy.compile(packed, net.specs, qc, net.input_shape, device=dev,
                              golden=False)
        errors = [f for f in verify_program(prog) if f.severity == "ERROR"]
        if errors:
            fail(f"{where}: verifier ERRORs {[str(f) for f in errors[:3]]}")
        per_call = {k: 0 for k in TPU_KERNELS}
        for i in prog.instrs:
            per_call[KERNEL_OF[i.kind]] += 1
        x = torch.randn((net.exec_batch,) + net.input_shape[1:],
                        generator=torch.Generator().manual_seed(seed + 99)).to(dev)
        for m in (None, 1):
            before = dict(launches)
            got = counted_launches(lambda: deploy.execute(prog, x, m), launches)
            if {k: launches[k] - before[k] for k in launches} != per_call:
                fail(f"{where} m_active={m}: launches {launches} (from {before}), want "
                     f"{per_call} more")
            if not torch.equal(got, fuzz.kernel_forward(net.specs, packed, x, m)):
                fail(f"{where} m_active={m}: execute is not torch.equal to the per-call "
                     f"kernel path")
            want = deploy.execute_reference(prog, x, m)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            if not bool(torch.isfinite(got).all()) or \
                    not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
                fail(f"{where} m_active={m}: max |d| vs plain {err:.3g} (max |logit| "
                     f"{scale:.3g})")
            worst = max(worst, err / max(scale, 1e-30))
        for f in fuzz.features(net):
            covered[f].append(seed)
    missing = [f for f, seeds in covered.items() if not seeds]
    if missing or any(v == 0 for v in launches.values()):
        fail(f"9a: features never drawn {missing} or a kernel never launched {launches}")
    res = {"seeds": len(FUZZ_SEEDS), "launches": launches, "worst_rel_err": worst,
           "features": {f: len(s) for f, s in covered.items()},
           "first_seed": {f: s[0] for f, s in covered.items()}, "seconds": time.time() - t0}
    print(f"phase 9a: {len(FUZZ_SEEDS)} fuzz networks compiled, verified (0 ERRORs), "
          f"executed at m_active None and 1: torch.equal to the per-call kernel path, "
          f"within rtol 1e-4 of the plain path (worst max|d|/max|logit| {worst:.3g}); "
          f"features {res['features']}; launches {launches}; {res['seconds']:.1f} s")
    return res


def lint_phase(programs: dict, inputs: dict) -> dict:
    """Phase 9b: the trace lint of phases 2-3's programs on the card."""
    out = {}
    for arch, program in programs.items():
        x = inputs[arch]
        scheds = (None, 1, [1 + (i % 2) for i in range(len(program))])
        fs = [f for m in scheds for f in trace_lint.lint_execute(program, x, m_active=m)]
        seen, _, _ = trace_lint.record_ops(lambda: deploy.execute(program, x), ())
        fs += trace_lint.retrace_findings(program, x, schedules=scheds, repeats=3)
        if fs:
            fail(f"9b: {arch}: {[str(f) for f in fs]}")
        out[arch] = {"findings": 0, "aten_ops_per_call": dict(sorted(seen.items()))}
        print(f"phase 9b: {arch}: lint_execute at m_active None, 1 and per layer, and "
              f"retrace over 3 repeats: 0 findings; aten ops of one call "
              f"{out[arch]['aten_ops_per_call']}")
    return out


def server_rounds(scen, rounds: int) -> list:
    """Drive a server scenario ``rounds`` steps; after each, every admitted
    request's tokens so far and last logits."""
    srv, admitted = scen.subject, []
    admit = srv.admit

    def recording(req):
        admitted.append(req)
        return admit(req)

    srv.admit = recording
    out = []
    try:
        for i in range(1, rounds + 1):
            scen.step(i)
            out.append([(list(r.out_tokens), None if r.last_logits is None
                         else r.last_logits.copy()) for r in admitted])
    finally:
        del srv.admit       # the wrapper and the server form a reference cycle
    return out


def family_parity(family: str, dev) -> int:
    """The first decode rounds of a server scenario on the card against the
    same scenario on the CPU: tokens equal, logits within phase 7's rtol
    2e-5 / atol 5e-5.  Returns the number of requests compared."""
    card = server_rounds(soak_sc.server_scenario(family=family, device=dev), PARITY_ROUNDS)
    host = server_rounds(soak_sc.server_scenario(family=family, device="cpu"),
                         PARITY_ROUNDS)
    for rnd, (a, b) in enumerate(zip(card, host), 1):
        if len(a) != len(b):
            fail(f"9c: {family} round {rnd}: {len(a)} requests on the card, {len(b)} on "
                 f"the CPU")
        for j, ((ta, la), (tb, lb)) in enumerate(zip(a, b)):
            if ta != tb:
                fail(f"9c: {family} round {rnd} request {j}: tokens {ta} != {tb}; top-2 "
                     f"margin {top2_margin(la):.3g} / {top2_margin(lb):.3g}")
            if (la is None) != (lb is None) or (
                    la is not None and not np.allclose(la, lb, rtol=2e-5, atol=5e-5)):
                fail(f"9c: {family} round {rnd} request {j}: logits differ "
                     f"(max |d| {np.abs(la - lb).max():.3g})")
    return len(card[-1])


def soak_one(name: str, scen, steps: int, csv_dir: Path, launches: dict) -> dict:
    """``run_soak`` + ``assert_flat`` at the JAX defaults; the soak's
    launches are counted.  Garbage of earlier phases is collected first, so
    the cycle collector frees none of it inside the soak's window."""
    gc.collect()
    t0 = time.time()
    result = counted_launches(
        lambda: run_soak(scen.step, steps=steps, name=name, gauges=scen.gauges), launches)
    result.write_csv(str(csv_dir / f"{name}_trend.csv"))
    try:
        result.assert_flat()
    except TrendViolation as e:
        fail(f"9c: {e}")
    progress = scen.progress()
    res = {"steps": steps, "seconds": time.time() - t0, "summary": result.summary(),
           "gauges": sorted(scen.gauges), "progress": progress,
           "median_step_ms": float(np.median(result.latency)) * 1e3}
    print(f"phase 9c: {result.summary()}; FLAT; gauges {res['gauges']}; median step "
          f"{res['median_step_ms']:.3f} ms; {res['seconds']:.1f} s")
    return res


def soak_phase(dev, out_dir: Path) -> dict:
    """Phase 9c: each scenario through run_soak + assert_flat, with the
    acceptance floors and reconciliations of the JAX soak tests."""
    t0 = time.time()
    csv_dir = out_dir / "soak"
    ckpt_dir = out_dir / "soak_ckpt"
    for d in (csv_dir, ckpt_dir):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    launches = {k: 0 for k in TPU_KERNELS}
    out = {}

    scen = soak_sc.executor_scenario(batch=16, mobilenet_kw=MOBILENET_B2, device=dev)
    if "exec_live_bytes" not in scen.gauges:
        fail("9c: the executor scenario gauges no live device bytes on the card")
    out["executor"] = soak_one("executor", scen, SOAK_STEPS["executor"], csv_dir, launches)
    if out["executor"]["progress"]["execute_calls"] < 500:
        fail(f"9c: executor: {out['executor']['progress']}")

    scen = soak_sc.cnn_server_scenario(directory=str(ckpt_dir / "cnn_server"), device=dev)
    out["cnn_server"] = soak_one("cnn_server", scen, SOAK_STEPS["cnn_server"], csv_dir,
                                 launches)
    p = scen.progress()
    st, inj = p["stats"], p["injected"]
    checks = {
        "verified > 100, 0 mismatches": p["verified"] > 100 and p["mismatches"] == 0,
        "errors injected == observed": st["exec_exceptions"] == inj["error"] > 0,
        "NaN/Inf injected == observed": st["nonfinite_detected"] == inj["nan"] + inj["inf"]
        and inj["nan"] > 0 and inj["latency"] > 0,
        "retried, nothing failed": st["retries"] > 0 and st["exec_failed_batches"] == 0
        and p["failed"] == 0,
        "reduced-M rungs and rung 0 served": st["rung_hist"].get(0, 0) > 0
        and sum(v for k, v in st["rung_hist"].items() if k > 0) > 0,
        "back to rung 0, not shedding": st["rung"] == 0 and not st["shedding"],
        "sheds at dispatch and admit": st["shed"]["deadline_expired"] > 0
        and st["shed"]["slo_shed"] > 0,
        "queue drained": st["queue_depth"] <= 2 * 4,
        "reloads == memory flips": st["reloads"] == inj["bitflip_mem"] > 0
        and st["selftest_failures"] == inj["bitflip_mem"],
        "quarantines == disk flips": st["quarantined_steps"] == p["ckpt_quarantined"]
        == inj["bitflip_disk"] > 0,
        "self-tests passed too": st["selftest_runs"] > st["selftest_failures"],
        "schedules within the ladder": len(scen.subject._schedules_seen)
        <= len(scen.subject.controller.ladder),
    }
    if not all(checks.values()):
        fail(f"9c: cnn_server reconciliation {[k for k, v in checks.items() if not v]}: {p}")
    print(f"phase 9c: cnn_server reconciled: {list(checks)}")

    scen = soak_sc.checkpoint_scenario(str(ckpt_dir / "checkpoint"), device=dev)
    out["checkpoint"] = soak_one("checkpoint", scen, SOAK_STEPS["checkpoint"], csv_dir,
                                 launches)
    if out["checkpoint"]["progress"]["cycles"] < 120 or \
            out["checkpoint"]["progress"]["ckpt_dirs"] > 2:
        fail(f"9c: checkpoint: {out['checkpoint']['progress']}")

    scen = soak_sc.server_scenario(device=dev)
    out["server"] = soak_one("server", scen, SOAK_STEPS["server"], csv_dir, launches)
    st = out["server"]["progress"]
    if st["decode_steps"] < 2000 or st["bulk_prefills"] <= 100:
        fail(f"9c: server: {st}")
    out["server"]["parity_requests"] = family_parity("gemma_2b", dev)

    for family in SOAK_FAMILIES:
        out[family] = soak_one(f"server_{family}",
                               soak_sc.server_scenario(family=family, device=dev),
                               FAMILY_STEPS, csv_dir, launches)
        out[family]["parity_requests"] = family_parity(family, dev)
        print(f"phase 9c: {family}: the first {PARITY_ROUNDS} rounds' tokens equal and "
              f"logits within rtol 2e-5 / atol 5e-5 of the CPU copy "
              f"({out[family]['parity_requests']} requests)")
    if any(v == 0 for v in launches.values()):
        fail(f"9c: a kernel never launched in the soaks: {launches}")
    out["launches"] = launches
    out["seconds"] = time.time() - t0
    print(f"phase 9c: every soak FLAT (gauges exactly flat, live device bytes included); "
          f"launches {launches}; trend CSVs in {csv_dir.relative_to(ROOT)}; "
          f"{out['seconds']:.1f} s")
    return out


def verify_phase(programs: dict, inputs: dict, dev, out_dir: Path) -> dict:
    """Phase 9: fuzz (9a), lint (9b) and soak (9c)."""
    t0 = time.time()
    res = {"fuzz": fuzz_phase(dev), "lint": lint_phase(programs, inputs),
           "soak": soak_phase(dev, out_dir)}
    res["seconds"] = time.time() - t0
    print(f"phase 9: {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 10: the MoE family (DeepSeek-V3, grok-1)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("deepseek_v3_671b", "grok_1_314b")
MOE_DEPTH = {"deepseek_v3_671b": 4, "grok_1_314b": 2}  # DeepSeek: 3 leading dense + 1 MoE
MOE_LINEARS = {  # arch -> label -> the path of one packed linear of that shape
    "deepseek_v3_671b": {
        "wdq": ("layers", "attn", "wdq"), "wuq": ("layers", "attn", "wuq"),
        "wdkv": ("layers", "attn", "wdkv"), "wo": ("layers", "attn", "wo"),
        "dense gate/up": ("dense_layers", "ffn", "w_gate"),
        "dense down": ("dense_layers", "ffn", "w_down"),
        "shared gate/up": ("layers", "moe", "shared", "w_gate"),
        "shared down": ("layers", "moe", "shared", "w_down"),
        "mtp proj": ("mtp", "proj")},
    "grok_1_314b": {"q/o": ("layers", "attn", "wq"), "k/v": ("layers", "attn", "wk")},
}
MOE_MATMULS_PER_PASS = {  # matmul launches per admission and per decode group step
    "deepseek_v3_671b": 4 * (4 + 3),   # MLA wdq/wuq/wdkv/wo + dense or shared gate/up/down
    "grok_1_314b": 2 * 4}              # q/k/v/o; the routed experts run no packed linear


def moe_config(name: str):
    """The published widths, cut in depth only, fp32, M=2 binary linears."""
    return get_config(name).replace(n_layers=MOE_DEPTH[name], dtype="float32",
                                    quant=QuantConfig(mode="binary", M=2, K_iters=8))


def stacked_layers(draw, cfg, n: int) -> tuple[dict, float]:
    """``n`` layers, each drawn by ``draw()`` and binarized at once, into
    ``[n, ...]`` leaves, and the seconds binarize took.  A one-layer stack
    is a view of its layer; a longer one is allocated once and filled, since
    two copies of a full-width expert bank do not fit on the card."""
    stack, bin_s = None, 0.0
    for i in range(n):
        fp = draw()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        layer = api.binarize_model_params(cfg, fp)
        torch.cuda.synchronize()
        bin_s += time.perf_counter() - t1
        del fp
        if n == 1:
            return cm.tree_map(lambda t: t.unsqueeze(0), layer), bin_s
        if stack is None:
            stack = cm.tree_map(lambda t: t.new_empty((n, *t.shape)), layer)
        cm.tree_map(lambda s, t: s[i].copy_(t), stack, layer)
        del layer
    return stack, bin_s


def build_moe_lm(cfg, dev) -> tuple[dict, dict]:
    """Phase 10: the weights drawn on the card from a seeded generator,
    each layer binarized as soon as it is drawn (the routed expert banks
    stay fp32, as the JAX package leaves them), the MTP head too."""
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dt = cfg.torch_dtype
    params = {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev)}
    bin_s = 0.0
    if cfg.n_dense_layers:
        params["dense_layers"], s = stacked_layers(
            lambda: tf.init_layer(gen, cfg, kind="dense", device=dev), cfg, cfg.n_dense_layers)
        bin_s += s
    params["layers"], s = stacked_layers(lambda: tf.init_layer(gen, cfg, kind="moe", device=dev),
                                         cfg, cfg.n_layers - cfg.n_dense_layers)
    bin_s += s
    params["final_norm"] = cm.init_rmsnorm(cfg.d_model, dt, device=dev)
    if not cfg.tie_embeddings:
        params["unembed"] = cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev)
    if cfg.mtp_depth:
        params["mtp"] = api.binarize_model_params(cfg, {
            "proj": cm.init_linear(gen, 2 * cfg.d_model, cfg.d_model, dt, device=dev),
            "layer": tf.init_layer(gen, cfg, kind="dense", device=dev),
            "norm": cm.init_rmsnorm(cfg.d_model, dt, device=dev)})
    torch.cuda.synchronize()
    leaves = cm.tree_leaves(params)
    moe = params["layers"]["moe"]
    info = {"build_s": time.perf_counter() - t0, "binarize_s": bin_s,
            "params": api.count_params(cfg),
            "active_params": api.count_params(cfg, active_only=True),
            "routed_expert_gb": sum(moe[k].numel() * moe[k].element_size()
                                    for k in ("w_gate", "w_up", "w_down")) / 1e9,
            "tables_gb": sum(params[k]["table"].numel() * 4 for k in ("embed", "unembed")
                             if k in params) / 1e9,
            "packed_gb": sum(t.numel() for t in leaves if t.dtype == torch.uint8) / 1e9,
            "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"phase 10: {cfg.name} {cfg.n_layers} layers ({cfg.n_dense_layers} dense), d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} at {cfg.d_ff_expert}, "
          f"vocab {cfg.vocab}: {info['params']:,} params ({info['active_params']:,} active); "
          f"built in {info['build_s']:.2f} s, of which binarize {bin_s:.2f} s; routed experts "
          f"{info['routed_expert_gb']:.2f} GB fp32, tables {info['tables_gb']:.2f} GB, packed "
          f"{info['packed_gb']:.3f} GB; card memory in use {info['memory_allocated_gb']:.2f} GB "
          f"(peak {info['max_memory_allocated_gb']:.2f} GB)")
    return params, info


def linear_weights(paths: dict, params) -> dict:
    """One packed linear of each shape of ``paths`` (label -> its path in
    the tree), labelled "label K->N"."""
    out = {}
    for label, path in paths.items():
        p = params
        for k in path:
            p = p[k]
        if p["B_packed"].ndim == 4:       # a stacked layer: its first entry
            p = cm.tree_index(p, 0)
        out[f"{label} {p['B_packed'].shape[1] * 8}->{p['B_packed'].shape[2]}"] = p
    return out


@contextlib.contextmanager
def recording_moe(into: list):
    """Within the block, each ``moe_ffn`` call appends whether it decoded,
    the router's expert ids (recomputed by ``moe.route``, no kernel) and
    its ``dropped_frac``, all left on the device."""
    real = moe_mod.moe_ffn

    def wrapped(params, x, cfg):
        y, aux = real(params, x, cfg)
        into.append({"decode": x.shape[1] == 1, "ids": moe_mod.route(params, x, cfg)[2],
                     "dropped_frac": aux["dropped_frac"]})
        return y, aux

    moe_mod.moe_ffn = wrapped
    try:
        yield into
    finally:
        moe_mod.moe_ffn = real


def moe_per_token(p: dict, x: torch.Tensor, cfg) -> tuple:
    """The plain reference of a MoE layer, used by no path of the port: the
    router in fp32, then the tokens walked in order (decode: the B rows as
    one group), each pick's rank in its expert replayed, each kept (token,
    expert) pair's SwiGLU computed directly in fp32, and the shared expert
    through the plain binary matmul.  Returns (y, expert ids [G, Sg, k],
    dropped picks, picks)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G, Sg = (1, B) if S == 1 else (B, S)
    xg = x.reshape(G, Sg, D).to(torch.float32)
    probs = torch.softmax(xg @ p["router"]["w"], dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    capacity = max(1, int(cfg.capacity_factor * Sg * k / E))
    y = torch.zeros_like(xg)
    dropped = 0
    for g, rows in enumerate(ids.cpu().tolist()):
        taken = [0] * E
        for t, picks in enumerate(rows):
            for j, e in enumerate(picks):
                taken[e] += 1
                if taken[e] > capacity:
                    dropped += 1
                    continue
                xt = xg[g, t]
                h = F.silu(xt @ p["w_gate"][e]) * (xt @ p["w_up"][e])
                y[g, t] += gates[g, t, j] * (h @ p["w_down"][e])
    if "shared" in p:
        def lin(q, v):
            K = v.shape[-1]
            return kref.binary_matmul_ref(v, q["B_packed"], q["alpha"], K=K,
                                          group_size=K // q["alpha"].shape[1])

        sh = p["shared"]
        y += lin(sh["w_down"], F.silu(lin(sh["w_gate"], xg)) * lin(sh["w_up"], xg))
    return y.reshape(B, S, D), ids, dropped, G * Sg * k


def topk_margin(probs: torch.Tensor, k: int) -> float:
    """The least gap between the k-th and (k+1)-th router probability."""
    top = torch.topk(probs, k + 1, dim=-1).values
    return float((top[..., k - 1] - top[..., k]).min())


def moe_vs_reference(cfg, params, gen: torch.Generator, dev) -> dict:
    """Phase 10a check 2: the full-width MoE layer on the card against
    ``moe_per_token`` for a 64-token prefill and an 8-row decode: expert ids
    equal, the same dropped picks, outputs within rtol 1e-4 /
    atol 1e-4·max|y|."""
    p = cm.tree_index(params["layers"]["moe"], 0)
    out = {}
    for what, shape in (("prefill", (1, LM_BUCKET, cfg.d_model)),
                        ("decode", (LM_BATCH, 1, cfg.d_model))):
        x = torch.randn(shape, generator=gen).to(dev)
        got, aux = moe_mod.moe_ffn(p, x, cfg)
        probs, _, ids = moe_mod.route(p, x, cfg)
        want, want_ids, dropped, picks = moe_per_token(p, x, cfg)
        if not torch.equal(ids, want_ids):
            fail(f"10a {what}: expert ids differ from the reference's at "
                 f"{int((ids != want_ids).sum())} picks; least top-{cfg.top_k} margin "
                 f"{topk_margin(probs, cfg.top_k):.3g}")
        port_dropped = round(float(aux["dropped_frac"]) * picks)
        if port_dropped != dropped:
            fail(f"10a {what}: {port_dropped} picks dropped, the reference drops {dropped}")
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or \
                not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
            fail(f"10a {what}: MoE layer vs per-token reference max |d| {err:.3g} "
                 f"(max |y| {scale:.3g})")
        out[what] = {"tokens": shape[0] * shape[1], "picks": picks, "dropped": dropped,
                     "dropped_frac": dropped / picks, "max_abs_err": err, "max_abs_y": scale,
                     "topk_margin": topk_margin(probs, cfg.top_k)}
        print(f"phase 10: MoE layer at full width, {what} of {out[what]['tokens']} tokens: "
              f"expert ids equal to the per-token reference, {dropped} of {picks} picks "
              f"dropped on both sides (dropped_frac {dropped / picks:.4f}), max |d| {err:.3g} "
              f"of max |y| {scale:.3g}; least top-k margin {out[what]['topk_margin']:.3g}")
    return out


def moe_card_vs_plain(cfg, params) -> dict:
    """Phase 10a check 3: the first leading dense layer (MLA + dense FFN) at
    full width, as the main stack of a 1-layer model, on the card against
    the plain versions on a CPU copy (all 3 leading layers until the script
    grew phase 12; the other two run the same code)."""
    cfg1 = cfg.replace(n_layers=1, n_dense_layers=0, mtp_depth=0)
    card = {k: params[k] for k in ("embed", "unembed", "final_norm")}
    card["layers"] = cm.tree_map(lambda t: t[:1], params["dense_layers"])
    worst = card_vs_plain("10a", cfg1, card)
    print(f"phase 10: {cfg1.n_layers} dense MLA layer at full width, prefill of 16 tokens + 2 "
          f"decode steps: card within rtol 1e-4 / atol 1e-4·max|x| of the plain versions on "
          f"the CPU (logits, every c_kv/k_rope leaf); worst max|d|/max|x| {worst:.3g}")
    return {"worst_rel_err": worst}


def run_requests(where: str, cfg, params, per_pass: int, launches: dict | None,
                 requests=lm_requests):
    """``requests(cfg)`` through ``Server(max_batch=8, max_len=256)`` until
    done; with ``launches``, the counts are set to 0 just before each
    admission and each step, read just after, held to ``per_pass`` matmul
    launches per pass (a bulk admission, each step of a token-wise one, a
    decode group step) and added up."""
    reqs = requests(cfg)
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)

    def admitted() -> int:
        return srv.stats["bulk_prefills"] + srv.stats["tokenwise_prefill_steps"]
    rounds = 0

    def counted(fn, passes):
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        n = ops.launch_counts()
        if launches is None:
            return
        if n["binary_matmul"] != passes() * per_pass or n["binary_conv"] \
                or n["binary_dwconv"]:
            fail(f"{where} serve {cfg.name}: launches {n}, want {passes()} x {per_pass} "
                 f"matmul launches")
        for k, v in n.items():
            launches[k] += v

    for r in reqs:
        before = admitted()
        counted(lambda: srv.admit(r) or fail(f"{where} serve: admission refused"),
                lambda: admitted() - before)
    while any(s is not None for s in srv.slots):
        before = srv.stats["decode_steps"]
        counted(srv.step, lambda: srv.stats["decode_steps"] - before)
        rounds += 1
    return reqs, srv, rounds


def serve_twice(where: str, cfg, params, per_pass: int, requests=lm_requests):
    """The main path (``run_requests`` with its launches counted), every
    request done with finite logits, then the same requests on a fresh
    server: the same tokens and bit-equal logits.  Returns the first run's
    requests, server, rounds, launches and seconds."""
    launches = {k: 0 for k in TPU_KERNELS}
    t0 = time.perf_counter()
    reqs, srv, rounds = run_requests(where, cfg, params, per_pass, launches, requests)
    serve_s = time.perf_counter() - t0
    for r in reqs:
        if not r.done or len(r.out_tokens) != LM_NEW or r.last_logits.shape != (cfg.vocab,) \
                or not np.isfinite(r.last_logits).all() \
                or not all(0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"{where} serve {cfg.name}: request of {r.prompt.size} tokens ended with "
                 f"{r.out_tokens}")
    again = run_requests(where, cfg, params, per_pass, None, requests)[0]
    for a, b in zip(reqs, again):
        if a.out_tokens != b.out_tokens or not np.array_equal(a.last_logits, b.last_logits):
            fail(f"{where} serve {cfg.name}: a second run differs: {a.out_tokens} / "
                 f"{b.out_tokens}")
    return reqs, srv, rounds, launches, serve_s


def serve_moe(cfg, params, per_pass: int) -> dict:
    """Phase 10's main path: 8 requests through ``Server`` until done, the
    launch counts set to 0 just before each admission and each step and
    read just after (``per_pass`` matmul launches per admission and per
    decode group step); then the same requests again on a fresh server:
    the same tokens and bit-equal logits."""
    routes = []
    with recording_moe(routes):
        reqs, srv, rounds, launches, serve_s = serve_twice("10", cfg, params, per_pass)
    routes = routes[:len(routes) // 2]      # the first run's calls; the second repeats them
    drop = {w: [float(c["dropped_frac"]) for c in routes if c["decode"] == (w == "decode")]
            for w in ("prefill", "decode")}
    res = {"stats": srv.stats, "rounds": rounds, "serve_s": serve_s, "launches": launches,
           "per_pass": per_pass, "prompt_lens": [int(r.prompt.size) for r in reqs],
           "out_tokens": [r.out_tokens for r in reqs], "moe_calls": len(routes),
           "dropped_frac": {w: {"mean": statistics.mean(v), "min": min(v), "max": max(v)}
                            for w, v in drop.items()}}
    print(f"phase 10: {cfg.name} served {len(reqs)} requests (prompts {res['prompt_lens']}, "
          f"m_active None/1/per-layer) in {rounds} rounds, {serve_s:.2f} s; stats "
          f"{srv.stats}; {per_pass} matmul launches per admission and per decode group step; "
          f"dropped_frac at prefill {res['dropped_frac']['prefill']}, at decode "
          f"{res['dropped_frac']['decode']}; a second run gave the same tokens and bit-equal "
          f"logits")
    return res


def op_device_us(prof, op: str, pred) -> float:
    """Device time of the profiled ``op`` calls whose input shapes satisfy
    ``pred``."""
    return sum(e.device_time_total for e in prof.key_averages(group_by_input_shape=True)
               if e.key == op and pred([tuple(s) for s in e.input_shapes if s]))


def decode_step_work(cfg, params, srv) -> dict:
    """Bytes and operations one decode step at 8 slots must move and do:
    every weight it reads once (the whole routed bank: each expert gets a
    slot at capacity 1 or more), the 8 embedding rows, the caches read and
    the logits written; operations 2 per MAC of the linears at 8 tokens
    (packed ones fp-equivalent), of the routed experts at E x capacity
    rows, of the attention over the whole cache and of the LM head."""
    B, E, k = LM_BATCH, cfg.n_experts, cfg.top_k
    capacity = max(1, int(cfg.capacity_factor * B * k / E))
    serving = {key: v for key, v in params.items() if key not in ("embed", "mtp")}
    nbytes = sum(t.numel() * t.element_size() for t in cm.tree_leaves(serving))
    nbytes += B * cfg.d_model * 4 + sum(t.numel() * t.element_size()
                                        for t in cm.tree_leaves(srv.cache))
    nbytes += B * cfg.vocab * 4
    macs = 0
    for t in cm.tree_leaves(serving):
        if t.dtype == torch.uint8:             # packed [L, M, K/8, N]: fp-equivalent MACs
            macs += B * t[:, 0].numel() * 8
    moe = params["layers"]["moe"]
    macs += E * capacity * sum(moe[w][:, 0].numel() for w in ("w_gate", "w_up", "w_down"))
    macs += B * cfg.vocab * cfg.d_model
    W, H = LM_LEN, cfg.n_heads              # attention over the whole cache, masked
    if cfg.use_mla:
        rank, qk, r, vd = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        per_layer = B * H * (qk * rank + W * (2 * rank + r) + rank * vd)
    else:
        per_layer = 2 * B * H * cfg.resolved_head_dim * W
    macs += cfg.n_layers * per_layer
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": 2 * macs, "capacity": capacity,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations"}


def moe_timing(cfg, params, dev, out_dir: Path, profile_name: str | None) -> dict:
    """Phase 10 timings: admission of a 64-token prompt, a decode step at 8
    slots beside its bound, and (``profile_name``) a profiler window of 3
    decode steps: device busy, idle share, and the device time of the
    matmul kernel, the routed-expert products, the absorbed MLA products
    and the LM head."""
    step, srv = decode_timing("phase 10", cfg, params)
    work = decode_step_work(cfg, params, srv)
    step["work"] = work
    print(f"phase 10: {cfg.name} decode step bound {work['bound_ms']:.3f} ms "
          f"({work['bound_by']}: {work['bytes'] / 1e9:.2f} GB, {work['flops'] / 1e9:.1f} "
          f"GFLOP, capacity {work['capacity']} per expert) against "
          f"{step['decode_step_events_ms']:.3f} ms (CUDA events)")
    if profile_name is None:
        return step
    from torch.profiler import ProfilerActivity, profile, schedule
    path = out_dir / f"trace_{profile_name}.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=3, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(4):
            srv.step()
            torch.cuda.synchronize()
            prof.step()
    split = device_split(json.loads(path.read_text())["traceEvents"])
    E, D, rank = cfg.n_experts, cfg.d_model, cfg.kv_lora_rank
    parts = {
        "binary_matmul": sum(us for n, us in split["device_us_by_name"].items()
                             if "binary_matmul" in n),
        "routed_experts": op_device_us(prof, "aten::bmm", lambda ss: any(
            s[0] == E and D in s[1:] for s in ss)),
        "absorbed_mla": op_device_us(prof, "aten::bmm", lambda ss: any(
            rank in s for s in ss) and not any(s[0] == E for s in ss)),
        "lm_head": op_device_us(prof, "aten::mm", lambda ss: any(cfg.vocab in s for s in ss))}
    if parts["binary_matmul"] == 0 or parts["lm_head"] == 0:
        fail(f"10 profile: device time by part {parts}")
    split.update({f"{k}_us_per_step": v / 3 for k, v in parts.items()})
    print(f"phase 10: profiler over 3 decode steps: window {split['window_us'] / 3e3:.4f} ms "
          f"per step, device busy {split['busy_us'] / 3e3:.4f} ms, idle share "
          f"{split['idle_share']:.4f}; per step: " + ", ".join(
              f"{k} {v / 3e3:.4f} ms" for k, v in parts.items()) +
          f"; trace {path.relative_to(ROOT)}")
    for name, us in list(split["device_us_by_name"].items())[:10]:
        print(f"  {us / 3e3:.5f} ms per step  {name[:110]}")
    return {**step, "profile": split}


def reduced_parity(phase: str, name: str, dev) -> dict:
    """``reduced(name)`` in fp32 with M=2 binary linears served on the card
    and on a CPU copy: 8 requests (m_active None, 1, per layer, 2) through
    ``Server(max_batch=4)``, the first 4 rounds' tokens equal, logits within
    rtol 2e-5 / atol 5e-5, every MoE call's expert ids equal."""
    cfg = reduced(get_config(name)).replace(dtype="float32",
                                            quant=QuantConfig(mode="binary", M=2, K_iters=2))
    host = api.binarize_model_params(
        cfg, api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(3, 12, 8)]
    modes = [None, 1, tuple(1 + i % 2 for i in range(cfg.n_layers)), 2] * 2
    sides = {}
    for side, params in (("card", cm.tree_map(lambda t: t.to(dev), host)), ("cpu", host)):
        srv = Server(cfg, params, max_batch=4, max_len=32)
        reqs = [Request(prompt=p, max_new_tokens=2, m_active=m) for p, m in zip(prompts, modes)]
        pending, rounds, routes = list(reqs), [], []
        with recording_moe(routes):
            for _ in range(PARITY_ROUNDS):
                while pending and srv.admit(pending[0]):
                    pending.pop(0)
                srv.step()
                rounds.append([(list(r.out_tokens), None if r.last_logits is None
                                else r.last_logits.copy()) for r in reqs])
        sides[side] = (rounds, [c["ids"].cpu() for c in routes])
    (card, card_ids), (cpu, cpu_ids) = sides["card"], sides["cpu"]
    if len(card_ids) != len(cpu_ids) or not all(torch.equal(a, b)
                                                for a, b in zip(card_ids, cpu_ids)):
        fail(f"{phase} {name}: the expert ids of the {len(card_ids)} MoE calls differ from "
             f"the CPU's {len(cpu_ids)}")
    for rnd, (a, b) in enumerate(zip(card, cpu), 1):
        for j, ((ta, la), (tb, lb)) in enumerate(zip(a, b)):
            if ta != tb:
                fail(f"{phase} {name} round {rnd} request {j}: tokens {ta} != {tb}")
            if (la is None) != (lb is None) or (
                    la is not None and not np.allclose(la, lb, rtol=2e-5, atol=5e-5)):
                fail(f"{phase} {name} round {rnd} request {j}: logits differ")
    served = sum(t != [] for t, _ in card[-1])
    print(f"phase {phase}: reduced {name}: the first {PARITY_ROUNDS} rounds of {served} "
          f"requests' tokens equal and logits within rtol 2e-5 / atol 5e-5 of the CPU copy"
          + (f"; the expert ids of all {len(card_ids)} MoE calls equal" if card_ids else ""))
    return {"requests": served, "moe_calls": len(card_ids)}


def reduced_train(phase: str, name: str, dev) -> dict:
    """One ``build_train_step`` fake-quant step of ``reduced(name)`` (fp32,
    TF32 off) on the card and on the CPU from the same state: every metric
    (loss, ce_loss and the MoE family's load_balance_loss and mtp_loss)
    within rtol 1e-5, and the card's gradients finite."""
    cfg = reduced(get_config(name)).replace(
        dtype="float32", quant=QuantConfig(mode="fake_quant", M=2, K_iters=4))
    opt = adamw(1e-2, eps=1e-3)
    host = train_steps.init_train_state(cfg, opt, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 17), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family in ("encdec", "vlm"):     # the stub frontends' embeddings
        key, n = (("frame_embeds", cfg.encoder_len) if cfg.family == "encdec"
                  else ("patch_embeds", cfg.n_image_tokens))
        batch[key] = torch.randn((4, n, cfg.d_model), generator=torch.Generator().manual_seed(2))
    out = {}
    for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
        state = cm.tree_map(lambda t: t.clone().to(d) if t.ndim else t.clone(), host)
        on = cm.tree_map(lambda t: t.to(d), batch)
        if side == "card":
            grads, _ = train_steps.loss_and_grads(lambda p, b: api.loss_fn(cfg, p, b),
                                                  state["params"], on)
            if not all(bool(torch.isfinite(g).all()) for g in cm.tree_leaves(grads)):
                fail(f"{phase} train step {name}: a gradient on the card is not finite")
        _, met = train_steps.build_train_step(cfg, opt)(state, on)
        out[side] = {k: float(v) for k, v in met.items() if k != "skipped"}
    for k, want in out["cpu"].items():
        if not math.isfinite(out["card"][k]) or \
                not math.isclose(out["card"][k], want, rel_tol=1e-5):
            fail(f"{phase} train step {name}: {k} {out['card'][k]!r} on the card, {want!r} on "
                 f"the CPU")
    print(f"phase {phase}: a fake-quant train step of reduced {name} on the card: "
          f"{out['card']}, within rtol 1e-5 of the CPU's; gradients finite")
    return out


def moe_phase(gen: torch.Generator, dev, out_dir: Path) -> dict:
    """Phase 10: DeepSeek-V3 (a) and grok-1 (b) at their published widths,
    then the reduced configs against a CPU copy (c)."""
    t0 = time.time()
    res = {"launches": {k: 0 for k in TPU_KERNELS}}
    for name in MOE_ARCHS:
        t1 = time.time()
        cfg = moe_config(name)
        params, build = build_moe_lm(cfg, dev)
        weights = linear_weights(MOE_LINEARS[name], params)
        r = {"config": {k: getattr(cfg, k) for k in (
                 "name", "n_layers", "n_dense_layers", "d_model", "n_heads", "n_kv_heads",
                 "d_ff", "d_ff_expert", "n_experts", "top_k", "n_shared_experts", "vocab",
                 "use_mla", "q_lora_rank", "kv_lora_rank", "mtp_depth", "dtype")} | {"M": 2},
             "build": build,
             "max_abs_err": check_linear_kernels(f"phase 10 {name}", weights,
                                                 lm_rows(cfg, params), gen, dev)}
        if cfg.use_mla:
            r["moe_vs_reference"] = moe_vs_reference(cfg, params, gen, dev)
            r["card_vs_plain"] = moe_card_vs_plain(cfg, params)
        r["serve"] = serve_moe(cfg, params, MOE_MATMULS_PER_PASS[name])
        r["timing"] = moe_timing(cfg, params, dev, out_dir,
                                 "deepseek" if cfg.use_mla else None)
        r["linears"] = time_linears(f"phase 10 {name}", weights, gen, dev)
        r["seconds"] = time.time() - t1
        for k, v in r["serve"]["launches"].items():
            res["launches"][k] += v
        res[name] = r
        del params, weights
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 10: {name} {r['seconds']:.1f} s")
    res["reduced"] = {name: reduced_parity("10c", name, dev) for name in MOE_ARCHS}
    res["train"] = reduced_train("10c", "deepseek_v3_671b", dev)
    res["seconds"] = time.time() - t0
    print(f"phase 10: {res['seconds']:.1f} s; launches {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 11: the SSM (mamba2-2.7b) and hybrid (zamba2-7b) families
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2_2_7b", "zamba2_7b")
SSM_LINEARS = {  # arch -> label -> the path of one packed linear of that shape
    "mamba2_2_7b": {"in_proj": ("mamba_layers", "block", "in_proj"),
                    "out_proj": ("mamba_layers", "block", "out_proj")},
    "zamba2_7b": {"in_proj": ("mamba_layers", "block", "in_proj"),
                  "out_proj": ("mamba_layers", "block", "out_proj"),
                  "shared in_proj": ("shared", "in_proj"),
                  "shared q/k/v/o": ("shared", "attn", "wq"),
                  "shared gate/up": ("shared", "ffn", "w_gate"),
                  "shared down": ("shared", "ffn", "w_down")},
}
SSM_MATMULS_PER_PASS = {  # matmul launches per admission and per decode group step
    "mamba2_2_7b": 64 * 2,             # in_proj, out_proj per layer
    "zamba2_7b": 81 * 2 + 13 * 8}      # + the shared block's in_proj, q/k/v/o, gate/up/down
SSD_LENGTHS = (64, 256, 257)           # chunk 64, 256 and (257 is prime) 1


def ssm_config(name: str):
    """The published widths and depths, fp32, M=2 binary linears."""
    return get_config(name).replace(dtype="float32",
                                    quant=QuantConfig(mode="binary", M=2, K_iters=8))


def build_ssm_lm(cfg, dev) -> tuple[dict, dict]:
    """Phase 11: the weights drawn on the card from a seeded generator, each
    Mamba2 layer (and the hybrid's shared block) binarized as soon as it is
    drawn; the dynamics and norms stay fp32."""
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dt = cfg.torch_dtype
    params = {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev)}
    params["mamba_layers"], bin_s = stacked_layers(
        lambda: {"norm": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
                 "block": ssm_mod.init_mamba2(gen, cfg, device=dev)}, cfg, cfg.n_layers)
    if cfg.family == "hybrid":
        t1 = time.perf_counter()
        params["shared"] = api.binarize_model_params(cfg, hybrid_mod.init_shared(gen, cfg,
                                                                                 device=dev))
        torch.cuda.synchronize()
        bin_s += time.perf_counter() - t1
    params["final_norm"] = cm.init_rmsnorm(cfg.d_model, dt, device=dev)
    torch.cuda.synchronize()
    leaves = cm.tree_leaves(params)
    info = {"build_s": time.perf_counter() - t0, "binarize_s": bin_s,
            "params": api.count_params(cfg),
            "table_gb": params["embed"]["table"].numel() * 4 / 1e9,
            "packed_gb": sum(t.numel() for t in leaves if t.dtype == torch.uint8) / 1e9,
            "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"phase 11: {cfg.name} {cfg.n_layers} Mamba2 layers"
          + (f" + {hybrid_mod.n_attn_points(cfg)} shared-block points" if cfg.family == "hybrid"
             else "") +
          f", d_model {cfg.d_model}, state {cfg.ssm_state}, vocab {cfg.vocab}: "
          f"{info['params']:,} params; built in {info['build_s']:.2f} s, of which binarize "
          f"{bin_s:.2f} s; table {info['table_gb']:.3f} GB, packed {info['packed_gb']:.3f} GB; "
          f"card memory in use {info['memory_allocated_gb']:.2f} GB (peak "
          f"{info['max_memory_allocated_gb']:.2f} GB)")
    return params, info


def ssm_rows(cfg) -> list[int]:
    """Every row count phase 11 gives the matmul kernel: T = 1 (token-wise
    decode), the decode batch, each request's exact prefill length (the
    recurrent families are not padded), the 16-token card check, the
    32-token bulk check and the 64-token prompt (63 at admission, 64 in
    ``time_linears``)."""
    return sorted({1, LM_BATCH, 16, BULK_CHECK_TOKENS, LM_BUCKET - 1, LM_BUCKET,
                   *(r.prompt.size - 1 for r in lm_requests(cfg))})


def ssd_sequential(xh, dt, A, Bm, Cm, D):
    """The plain float64 token-by-token recurrence (the JAX package's
    ``tests/test_ssm.py`` ground truth), on the CPU; no path of the port
    calls it.  Returns y and the state after the last token."""
    xh, dt, A, Bm, Cm, D = (t.to("cpu", torch.float64) for t in (xh, dt, A, Bm, Cm, D))
    b, l, h, p = xh.shape
    rep = h // Bm.shape[2]
    Bh, Ch = Bm.repeat_interleave(rep, dim=2), Cm.repeat_interleave(rep, dim=2)
    state = torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(l):
        state = state * torch.exp(dt[:, t] * A)[..., None, None] + \
            (dt[:, t, :, None] * xh[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]) + D[None, :, None] * xh[:, t])
    return torch.stack(ys, 1), state


def ssd_vs_sequential(cfg, gen: torch.Generator, dev) -> dict:
    """Phase 11a check 2: ``ssd_chunked`` at full width (heads, head_dim,
    state, groups of ``cfg``) on the card against the float64 recurrence,
    y and the final state within rtol 2e-4 / atol 2e-4 (the reference's),
    at each length of ``SSD_LENGTHS`` with the chunk ``_mamba2_seq`` picks;
    inputs drawn as the reference's test draws them."""
    _, H, _ = ssm_mod._dims(cfg)
    p, g, n = cfg.ssm_head_dim, cfg.ssm_ngroups, cfg.ssm_state
    out = {}
    for L in SSD_LENGTHS:
        xh = torch.randn(1, L, H, p, generator=gen)
        dt = F.softplus(torch.randn(1, L, H, generator=gen))
        A = -torch.exp(torch.randn(H, generator=gen) * 0.5)
        Bm = torch.randn(1, L, g, n, generator=gen) * 0.5
        Cm = torch.randn(1, L, g, n, generator=gen) * 0.5
        D = torch.ones(H)
        chunk = min(cfg.ssm_chunk, L)
        while L % chunk:
            chunk -= 1
        y, state = ssm_mod.ssd_chunked(*(t.to(dev) for t in (xh, dt, A, Bm, Cm, D)), chunk,
                                       return_state=True)
        ry, rstate = ssd_sequential(xh, dt, A, Bm, Cm, D)
        errs = {}
        for what, a, b in (("y", y, ry), ("state", state, rstate)):
            a = a.cpu().double()
            errs[what] = float((a - b).abs().max())
            if not bool(torch.isfinite(a).all()) or \
                    not torch.allclose(a, b, rtol=2e-4, atol=2e-4):
                fail(f"11a SSD L={L} chunk {chunk}: {what} max |d| {errs[what]:.3g} vs the "
                     f"float64 recurrence")
        out[L] = {"chunk": chunk, "max_abs_err": errs}
    print(f"phase 11: ssd_chunked at full width ({H} heads x {p}, state {n}) against the "
          f"float64 recurrence, y and final state within rtol 2e-4 / atol 2e-4: " +
          ", ".join(f"L={L} chunk {r['chunk']} max |d| {r['max_abs_err']}"
                    for L, r in out.items()))
    return out


def rel_close(where: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """a within rtol 1e-4 / atol 1e-4·max|b| of b; returns max|d|/max|b|."""
    a, b = a.cpu(), b.cpu()
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    if not bool(torch.isfinite(a).all()) or scale == 0.0 or \
            not torch.allclose(a, b, rtol=1e-4, atol=1e-4 * scale):
        fail(f"{where}: max |d| {err:.3g}, max |x| {scale:.3g}")
    return err / scale


BULK_CHECK_TOKENS = 32   # 64 until the script grew phase 12


def bulk_vs_tokenwise(cfg, params, dev) -> float:
    """Phase 11 check 3: one 32-token prompt by bulk prefill and by 32
    token-wise decode steps (B=1) on the card: every cache leaf (state,
    pre-activation conv rows, the hybrid's KV) and the next step's logits
    within rtol 1e-4 / atol 1e-4·max|x|.  Returns the worst max|d|/max|x|."""
    n = BULK_CHECK_TOKENS
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, n + 1))).to(dev)
    _, bulk = api.prefill(cfg, params, toks[:, :n], max_len=LM_LEN)
    step = api.init_cache(cfg, 1, LM_LEN, device=dev)
    for t in range(n):
        api.decode_step(cfg, params, {"tokens": toks[:, t:t + 1], "cache": step,
                                      "pos": torch.tensor([t], device=dev)})
    worst = 0.0
    for a, b in zip(cm.tree_leaves(bulk), cm.tree_leaves(step)):
        worst = max(worst, rel_close(f"11 {cfg.name} bulk vs token-wise cache", a, b))
    nxt = {"tokens": toks[:, n:], "pos": torch.tensor([n], device=dev)}
    la, _ = api.decode_step(cfg, params, dict(nxt, cache=bulk))
    lb, _ = api.decode_step(cfg, params, dict(nxt, cache=step))
    worst = max(worst, rel_close(f"11 {cfg.name} bulk vs token-wise next logits", la, lb))
    print(f"phase 11: {cfg.name} bulk prefill of {n} tokens vs {n} token-wise "
          f"decode steps: every cache leaf and the next step's logits within rtol 1e-4 / atol "
          f"1e-4·max|x|; worst max|d|/max|x| {worst:.3g}")
    return worst


def ssm_card_vs_plain(cfg, params) -> dict:
    """Phase 11 check 4: the first 2 Mamba2 layers (mamba2) or the first 6
    and the shared block after them (zamba2) at full width on the card
    against the plain versions on a CPU copy."""
    depth = 2 if cfg.family == "ssm" else cfg.hybrid_attn_every
    card = {k: v for k, v in params.items() if k != "mamba_layers"}
    card["mamba_layers"] = cm.tree_map(lambda t: t[:depth], params["mamba_layers"])
    worst = card_vs_plain(f"11 {cfg.name}", cfg.replace(n_layers=depth), card)
    print(f"phase 11: {cfg.name} cut to {depth} layers at full width, prefill of 16 tokens + 2 "
          f"decode steps: card within rtol 1e-4 / atol 1e-4·max|x| of the plain versions on "
          f"the CPU (logits and every cache leaf); worst max|d|/max|x| {worst:.3g}")
    return {"layers": depth, "worst_rel_err": worst}


def state_rows(cfg, cache, slot: int) -> list:
    mamba = cache if cfg.family == "ssm" else cache["mamba"]
    return [t[:, slot].clone() for t in cm.tree_leaves(mamba)]


def slot_isolation(cfg, params) -> dict:
    """Phase 11: slot 0's recurrent state ``torch.equal`` before and after
    the 7 other requests' admissions, and across every decode group of the
    first round that it is not in."""
    reqs = lm_requests(cfg)
    srv = Server(cfg, params, max_batch=LM_BATCH, max_len=LM_LEN)
    srv.admit(reqs[0])
    before = state_rows(cfg, srv.cache, 0)
    for r in reqs[1:]:
        srv.admit(r)
    if not all(torch.equal(a, b) for a, b in zip(state_rows(cfg, srv.cache, 0), before)):
        fail(f"11 {cfg.name}: another slot's admission changed slot 0's state")
    real, checked = srv._decode, []

    def watched(m_active, tokens, mask):
        keep = None if mask[0] else state_rows(cfg, srv.cache, 0)
        out = real(m_active, tokens, mask)
        if keep is not None:
            checked.append(all(torch.equal(a, b)
                               for a, b in zip(state_rows(cfg, srv.cache, 0), keep)))
        return out

    srv._decode = watched
    try:
        srv.step()
    finally:
        del srv._decode        # the wrapper and the server form a reference cycle
    if not checked or not all(checked):
        fail(f"11 {cfg.name}: decode groups without slot 0 left its state {checked}")
    print(f"phase 11: {cfg.name}: slot 0's state bit-exact across 7 admissions and "
          f"{len(checked)} decode groups it is not in")
    return {"groups_checked": len(checked)}


def mixed_vs_alone(cfg, params, reqs: list) -> dict:
    """Phase 11: each of the first 3 requests (one of each mode: None, 1, a
    per-layer schedule; all 8 until the script grew phase 12) served alone
    gives the tokens it got in the 8-slot mix.  Alone in a server of the
    same 8 slots (the same shapes for
    every op, so only the update mask and the grouping differ) its logits
    are within rtol 1e-5 / atol 1e-5; alone at ``max_batch=1`` (cuBLAS and
    the row reductions then sum in another order) within rtol 2e-5 /
    atol 5e-5, phase 7's.  Returns the largest |d| of each."""
    worst = {}
    for batch, tol in ((LM_BATCH, 1e-5), (1, None)):
        worst[batch] = 0.0
        for r in reqs[:3]:
            solo = Server(cfg, params, max_batch=batch, max_len=LM_LEN)
            again = Request(prompt=r.prompt.copy(), max_new_tokens=LM_NEW, m_active=r.m_active)
            solo.admit(again)
            solo.run_until_done()
            kw = {} if tol is None else {"rtol": tol, "atol": tol}
            same_stream(f"11 {cfg.name}: a request of {r.prompt.size} tokens, m_active "
                        f"{r.m_active}, alone (max_batch {batch}) vs in the mix", again, r, **kw)
            worst[batch] = max(worst[batch],
                               float(np.abs(again.last_logits - r.last_logits).max()))
    print(f"phase 11: {cfg.name}: each of the first 3 requests served alone gave the tokens "
          f"it got in the mix; last logits max |d| {worst[LM_BATCH]:.3g} alone in 8 slots "
          f"(rtol 1e-5 / atol 1e-5), {worst[1]:.3g} at max_batch 1 (rtol 2e-5 / atol 5e-5)")
    return {"max_abs_d_8_slots": worst[LM_BATCH], "max_abs_d_1_slot": worst[1]}


def serve_ssm(cfg, params, per_pass: int) -> dict:
    """Phase 11's main path: 8 requests through ``Server`` (launches held to
    ``per_pass`` per admission and per decode group step), a second run
    bit-equal, one request of each mode alone equal to the mix, and slot
    isolation."""
    reqs, srv, rounds, launches, serve_s = serve_twice("11", cfg, params, per_pass)
    print(f"phase 11: {cfg.name} served {len(reqs)} requests (prompts "
          f"{[r.prompt.size for r in reqs]}, m_active None/1/per-layer) in {rounds} rounds, "
          f"{serve_s:.2f} s; stats {srv.stats}; {per_pass} matmul launches per admission and "
          f"per decode group step; a second run gave the same tokens and bit-equal logits")
    return {"stats": srv.stats, "rounds": rounds, "serve_s": serve_s, "launches": launches,
            "per_pass": per_pass, "prompt_lens": [int(r.prompt.size) for r in reqs],
            "out_tokens": [r.out_tokens for r in reqs],
            "alone": mixed_vs_alone(cfg, params, reqs),
            "isolation": slot_isolation(cfg, params)}


def ssm_step_work(cfg, params, srv) -> dict:
    """Bytes and operations one decode step at 8 slots must move and do:
    every weight read once (the table in the LM head), the 8 embedding
    rows, the recurrent state and conv rows read and written, the KV caches
    read and one row per slot and point written, the logits written;
    operations 2 per MAC of the linears at 8 tokens (packed ones
    fp-equivalent), of the state update and readout, of attention over the
    whole cache and of the LM head."""
    B, d = LM_BATCH, cfg.d_model
    nbytes = sum(t.numel() * t.element_size() for t in cm.tree_leaves(params))
    nbytes += B * d * 4 + B * cfg.vocab * 4
    mamba = srv.cache if cfg.family == "ssm" else srv.cache["mamba"]
    nbytes += 2 * sum(t.numel() * t.element_size() for t in cm.tree_leaves(mamba))
    _, H, conv_ch = ssm_mod._dims(cfg)
    macs = sum(B * t[:, 0].numel() * 8 if t.ndim == 4 else B * t[0].numel() * 8
               for t in cm.tree_leaves(params) if t.dtype == torch.uint8)
    macs += B * cfg.vocab * d
    macs += cfg.n_layers * B * (2 * H * cfg.ssm_head_dim * cfg.ssm_state
                                + cfg.ssm_conv_width * conv_ch)
    if cfg.family == "hybrid":
        kv = srv.cache["attn"]
        nbytes += sum(t.numel() * t.element_size() for t in cm.tree_leaves(kv))
        nbytes += sum(t[:, :, 0].numel() * t.element_size() for t in cm.tree_leaves(kv))
        macs += hybrid_mod.n_attn_points(cfg) * 2 * B * cfg.n_heads * cfg.resolved_head_dim \
            * LM_LEN
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": 2 * macs, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def self_device_us(prof, pred, ops_named=None) -> float:
    """Self device time (children excluded) of the profiled ops (those in
    ``ops_named``, or all) whose input shapes satisfy ``pred``."""
    return sum(e.self_device_time_total for e in prof.key_averages(group_by_input_shape=True)
               if (ops_named is None or e.key in ops_named)
               and pred([tuple(s) for s in e.input_shapes if s]))


def ssm_timing(cfg, params, dev, out_dir: Path, profile_name: str) -> dict:
    """Phase 11 timings: admission of a 64-token prompt, a decode step at 8
    slots beside its bound, and a profiler window of 3 decode steps: device
    busy, idle share, and the device time of the matmul kernel, of the ops
    on the recurrent state (update, readout, mask) and of the LM head."""
    step, srv = decode_timing("phase 11", cfg, params)
    work = ssm_step_work(cfg, params, srv)
    step["work"] = work
    print(f"phase 11: {cfg.name} decode step bound {work['bound_ms']:.3f} ms "
          f"({work['bound_by']}: {work['bytes'] / 1e9:.2f} GB, {work['flops'] / 1e9:.1f} GFLOP) "
          f"against {step['decode_step_events_ms']:.3f} ms (CUDA events)")
    from torch.profiler import ProfilerActivity, profile, schedule
    path = out_dir / f"trace_{profile_name}.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=3, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(4):
            srv.step()
            torch.cuda.synchronize()
            prof.step()
    trace = path.read_text()
    with gzip.open(path.with_suffix(".json.gz"), "wt") as f:   # keeps chiprun_out/ small
        f.write(trace)
    path.unlink()
    path = path.with_suffix(".json.gz")
    split = device_split(json.loads(trace)["traceEvents"])
    pn = (cfg.ssm_head_dim, cfg.ssm_state)
    parts = {
        "binary_matmul": sum(us for n, us in split["device_us_by_name"].items()
                             if "binary_matmul" in n),
        "state_ops": self_device_us(prof, lambda ss: any(len(s) >= 3 and s[-2:] == pn
                                                         for s in ss)),
        "lm_head": self_device_us(prof, lambda ss: any(cfg.vocab in s for s in ss),
                                  ("aten::mm", "aten::bmm", "aten::addmm"))}
    if parts["binary_matmul"] == 0 or parts["lm_head"] == 0 or parts["state_ops"] == 0:
        fail(f"11 profile {cfg.name}: device time by part {parts}")
    split.update({f"{k}_us_per_step": v / 3 for k, v in parts.items()})
    print(f"phase 11: profiler over 3 decode steps: window {split['window_us'] / 3e3:.4f} ms "
          f"per step, device busy {split['busy_us'] / 3e3:.4f} ms, idle share "
          f"{split['idle_share']:.4f}; per step: " + ", ".join(
              f"{k} {v / 3e3:.4f} ms" for k, v in parts.items()) +
          f"; trace {path.relative_to(ROOT)}")
    for name, us in list(split["device_us_by_name"].items())[:10]:
        print(f"  {us / 3e3:.5f} ms per step  {name[:110]}")
    return {**step, "profile": split}


def ssm_phase(gen: torch.Generator, dev, out_dir: Path) -> dict:
    """Phase 11: mamba2-2.7b (a) and zamba2-7b (b) at their published widths
    and depths, then the reduced configs against a CPU copy (c)."""
    t0 = time.time()
    res = {"launches": {k: 0 for k in TPU_KERNELS}}
    for name in SSM_ARCHS:
        t1 = time.time()
        cfg = ssm_config(name)
        params, build = build_ssm_lm(cfg, dev)
        weights = linear_weights(SSM_LINEARS[name], params)
        r = {"config": {k: getattr(cfg, k) for k in (
                 "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab", "ssm_state", "ssm_expand", "ssm_head_dim", "ssm_ngroups",
                 "ssm_conv_width", "ssm_chunk", "hybrid_attn_every", "dtype")} | {"M": 2},
             "build": build,
             "max_abs_err": check_linear_kernels(f"phase 11 {name}", weights, ssm_rows(cfg),
                                                 gen, dev)}
        if cfg.family == "ssm":
            r["ssd"] = ssd_vs_sequential(cfg, gen, dev)
        r["bulk_vs_tokenwise"] = bulk_vs_tokenwise(cfg, params, dev)
        r["card_vs_plain"] = ssm_card_vs_plain(cfg, params)
        r["serve"] = serve_ssm(cfg, params, SSM_MATMULS_PER_PASS[name])
        r["timing"] = ssm_timing(cfg, params, dev, out_dir, name.split("_")[0])
        r["linears"] = time_linears(f"phase 11 {name}", weights, gen, dev)
        r["seconds"] = time.time() - t1
        for k, v in r["serve"]["launches"].items():
            res["launches"][k] += v
        res[name] = r
        del params, weights
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 11: {name} {r['seconds']:.1f} s")
    res["reduced"] = {name: reduced_parity("11c", name, dev) for name in SSM_ARCHS}
    res["train"] = {name: reduced_train("11c", name, dev) for name in SSM_ARCHS}
    res["seconds"] = time.time() - t0
    print(f"phase 11: {res['seconds']:.1f} s; launches {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 12: the enc-dec (whisper-medium) and VLM (internvl2-2b) families
# ---------------------------------------------------------------------------

ENCDEC_ARCHS = ("whisper_medium", "internvl2_2b")
ENCDEC_LINEARS = {  # arch -> label -> the path of one packed linear of that shape
    "whisper_medium": {"q/k/v/o, cross": ("dec_layers", "attn", "wq"),
                       "up": ("dec_layers", "ffn", "w_up"),
                       "down": ("dec_layers", "ffn", "w_down")},
    "internvl2_2b": {"q/o": ("layers", "attn", "wq"), "k/v": ("layers", "attn", "wk"),
                     "gate/up": ("layers", "ffn", "w_gate"), "down": ("layers", "ffn", "w_down")},
}
ENCDEC_STEPS, VLM_TOKENS = 16, 64      # whisper's greedy decode steps; internvl2's tokens


def whisper_passes(cfg) -> dict:
    """Matmul launches of each whisper pass."""
    return {"encode": cfg.n_encoder_layers * 6 + cfg.n_layers * 2,   # + each layer's cross k/v
            "decode": cfg.n_layers * 8,                 # self q/k/v/o, cross q/o, up/down
            "forward": cfg.n_encoder_layers * 6 + cfg.n_layers * 10}  # + cross k/v per layer


def encdec_config(name: str):
    """The published widths and depths, fp32, M=2 binary linears."""
    return get_config(name).replace(dtype="float32",
                                    quant=QuantConfig(mode="binary", M=2, K_iters=8))


def build_encdec_lm(cfg, dev) -> tuple[dict, dict]:
    """Phase 12: the weights drawn on the card from a seeded generator, each
    encoder, decoder or LM layer binarized as soon as it is drawn; the
    norms and tables stay fp32."""
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dt = cfg.torch_dtype
    params = {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev)}
    if cfg.family == "encdec":
        params["enc_layers"], bin_s = stacked_layers(
            lambda: encdec_mod.init_enc_layer(gen, cfg, device=dev), cfg, cfg.n_encoder_layers)
        params["enc_norm"] = cm.init_rmsnorm(cfg.d_model, dt, device=dev)
        params["dec_layers"], s = stacked_layers(
            lambda: encdec_mod.init_dec_layer(gen, cfg, device=dev), cfg, cfg.n_layers)
        bin_s += s
    else:
        params["layers"], bin_s = stacked_layers(lambda: tf.init_layer(gen, cfg, device=dev),
                                                 cfg, cfg.n_layers)
        if not cfg.tie_embeddings:
            params["unembed"] = cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev)
    params["final_norm"] = cm.init_rmsnorm(cfg.d_model, dt, device=dev)
    torch.cuda.synchronize()
    leaves = cm.tree_leaves(params)
    info = {"build_s": time.perf_counter() - t0, "binarize_s": bin_s,
            "params": api.count_params(cfg),
            "tables_gb": sum(params[k]["table"].numel() * 4 for k in ("embed", "unembed")
                             if k in params) / 1e9,
            "packed_gb": sum(t.numel() for t in leaves if t.dtype == torch.uint8) / 1e9,
            "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"phase 12: {cfg.name} "
          + (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers (encoder_len "
             f"{cfg.encoder_len})" if cfg.family == "encdec" else
             f"{cfg.n_layers} layers ({cfg.n_image_tokens} image tokens)") +
          f", d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {info['params']:,} "
          f"params; built in {info['build_s']:.2f} s, of which binarize {bin_s:.2f} s; tables "
          f"{info['tables_gb']:.3f} GB, packed {info['packed_gb']:.3f} GB; card memory in use "
          f"{info['memory_allocated_gb']:.2f} GB (peak {info['max_memory_allocated_gb']:.2f} GB)")
    return params, info


def encdec_rows(cfg) -> list[int]:
    """Every row count phase 12 gives the matmul kernel: T = 1 (the CPU
    copy's decode), the 8 slots (decode, token-wise admission), 64, and
    whisper's 16-token forward at 8 rows and its encoder at 1 and 8 frame
    windows, or internvl2's prefix + 64 tokens at batch 1 and 2."""
    rows = {1, LM_BATCH, LM_BUCKET}
    if cfg.family == "encdec":
        return sorted(rows | {LM_BATCH * ENCDEC_STEPS, cfg.encoder_len,
                              LM_BATCH * cfg.encoder_len})
    n = cfg.n_image_tokens + VLM_TOKENS
    return sorted(rows | {n, 2 * n})


def counted_pass(where: str, want: int, fn):
    """``fn()`` through ``counted_launches``: exactly ``want`` matmul
    launches and no conv launch."""
    n = {k: 0 for k in TPU_KERNELS}
    out = counted_launches(fn, n)
    if n["binary_matmul"] != want or n["binary_conv"] or n["binary_dwconv"]:
        fail(f"{where}: launches {n}, want {want} matmul launches")
    return out


def packed_macs(tree, rows: int) -> int:
    """fp-equivalent MACs of every stacked packed linear ([L, M, K/8, N]) of
    ``tree`` at ``rows`` rows."""
    return sum(rows * t[:, 0].numel() * 8 for t in cm.tree_leaves(tree) if t.dtype == torch.uint8)


def nbytes_of(tree) -> int:
    return sum(t.numel() * t.element_size() for t in cm.tree_leaves(tree))


def cross_kv_weights(params) -> dict:
    """The decoder layers' cross k/v projections: run by the encode, never
    by a decode step."""
    return {k: params["dec_layers"]["xattn"][k] for k in ("wk", "wv")}


def timed(fn, reps: int) -> tuple[list, list]:
    """``fn()`` ``reps`` times: host-clock ms (ending in a synchronize) and
    CUDA-event ms of each."""
    host, events = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return host, events


def whisper_encode(cfg, params, frames) -> tuple[dict, dict]:
    """12a: ``init_encdec_cache`` over 8 frame windows (the encoder once, each
    decoder layer's cross K/V), its launches counted, then timed twice
    beside the operations bound: the packed linears at 1500 x 8 rows, the
    encoder's attention, the cross K/V; bytes the weights read, the frames
    read, the cross K/V written."""
    B, Se, H, hd = frames.shape[0], cfg.encoder_len, cfg.n_heads, cfg.resolved_head_dim
    passes = whisper_passes(cfg)

    def encode():
        return encdec_mod.init_encdec_cache(params, cfg, B, LM_LEN, frames, device=frames.device)

    cache = counted_pass("12a encode", passes["encode"], encode)
    if not all(bool(torch.isfinite(cache[k]).all()) for k in ("cross_k", "cross_v")):
        fail("12a encode: the cross K/V are not finite")
    host, events = timed(encode, 2)
    T = B * Se
    flops = {"linears": 2 * packed_macs(params["enc_layers"], T),
             "attention": 2 * cfg.n_encoder_layers * 2 * B * H * Se * Se * hd,
             "cross_kv": 2 * packed_macs(cross_kv_weights(params), T)}
    nbytes = (nbytes_of(params["enc_layers"]) + nbytes_of(cross_kv_weights(params))
              + frames.numel() * 4 + 2 * cache["cross_k"].numel() * 4)
    t_ops = sum(flops.values()) / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    res = {"batch": B, "rows": T, "launches": passes["encode"], "host_ms": host,
           "events_ms": events, "flops": flops, "bytes": nbytes,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
           else "bytes", "cross_kv_gb": 2 * cache["cross_k"].numel() * 4 / 1e9}
    print(f"phase 12: whisper encode of {B} frame windows ({T} rows per linear, "
          f"{passes['encode']} matmul launches): {min(host):.3f} ms host clock, "
          f"{min(events):.3f} ms CUDA events (best of 2) against a bound of "
          f"{res['bound_ms']:.3f} ms ({res['bound_by']}: " + ", ".join(
              f"{k} {v / 1e12:.2f} TFLOP" for k, v in flops.items()) +
          f"); cross K/V {res['cross_kv_gb']:.2f} GB")
    return cache, res


def whisper_decode_vs_forward(cfg, params, frames, cache, rng) -> dict:
    """12a: 16 greedy ``decode_step``s at 8 rows from the encoded cache (each
    counted), then the teacher-forced ``forward`` of the same 16 tokens
    (counted): its logits within rtol 1e-4 / atol 1e-4·max|x| of the decode
    loop's."""
    passes, B = whisper_passes(cfg), frames.shape[0]
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).to(frames.device)
    seq, logits = [tok], []
    for i in range(ENCDEC_STEPS):
        batch = {"tokens": tok, "cache": cache,
                 "pos": torch.full((B,), i, dtype=torch.int32, device=frames.device)}
        lg, cache = counted_pass(f"12a decode step {i}", passes["decode"],
                                 lambda: api.decode_step(cfg, params, batch))
        logits.append(lg[:, 0])
        tok = torch.argmax(lg[:, 0], dim=-1)[:, None]
        seq.append(tok)
    toks = torch.cat(seq[:-1], dim=1)
    fwd, _ = counted_pass("12a forward", passes["forward"], lambda: api.forward(
        cfg, params, {"tokens": toks, "frame_embeds": frames}))
    worst = rel_close("12a teacher-forced forward vs the decode loop", fwd,
                      torch.stack(logits, dim=1))
    print(f"phase 12: whisper {ENCDEC_STEPS} greedy decode steps at {B} rows "
          f"({passes['decode']} matmul launches each) and the teacher-forced forward of the same "
          f"tokens ({passes['forward']} launches): logits within rtol 1e-4 / atol 1e-4·max|x|, "
          f"max|d|/max|x| {worst:.3g}")
    return {"steps": ENCDEC_STEPS, "worst_rel_err": worst,
            "tokens": toks[0].tolist()}


def cut_copy(cfg, params, depth: int) -> tuple:
    """The config and params cut to ``depth`` layers (each stack) at full
    width; the card's tree shares the full one's storage."""
    cut = cfg.replace(n_layers=depth, n_encoder_layers=min(depth, cfg.n_encoder_layers))
    card = {k: (cm.tree_map(lambda t: t[:depth], v) if k.endswith("layers") else v)
            for k, v in params.items()}
    return cut, card


def encdec_card_vs_plain(cfg, params, frames, rng) -> dict:
    """12a: 2 encoder + 2 decoder layers at full width, ``encoder_len`` kept,
    one frame window, on the card and on a CPU copy (the plain versions):
    the encoder output, the cross K/V and 4 decode steps' logits within
    rtol 1e-4 / atol 1e-4·max|x|."""
    cut, card = cut_copy(cfg, params, 2)
    host = cm.tree_map(lambda t: t.to("cpu", copy=True), card)
    x = frames[:1]
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1, 1)))
    outs = {}
    for side, p in (("card", card), ("plain", host)):
        d = p["embed"]["table"].device
        xd = x.to(d)
        got = [encdec_mod.encode(p, cut, xd)]
        cache = encdec_mod.init_encdec_cache(p, cut, 1, 32, xd, device=d)
        got += [cache["cross_k"], cache["cross_v"]]
        for i in range(4):
            lg, cache = api.decode_step(cut, p, {"tokens": steps[i].to(d), "cache": cache,
                                                 "pos": torch.tensor([i], device=d)})
            got.append(lg)
        outs[side] = got
    names = ["encoder output", "cross k", "cross v"] + [f"decode step {i} logits"
                                                        for i in range(4)]
    worst = max(rel_close(f"12a card vs plain ({n})", a, b)
                for n, a, b in zip(names, outs["card"], outs["plain"]))
    print(f"phase 12: whisper cut to 2 encoder + 2 decoder layers at full width, one window of "
          f"{cfg.encoder_len} frames: the encoder output, the cross K/V and 4 decode steps' "
          f"logits on the card within rtol 1e-4 / atol 1e-4·max|x| of the plain versions on the "
          f"CPU; worst max|d|/max|x| {worst:.3g}")
    return {"worst_rel_err": worst}


def vlm_forward(cfg, params, gen: torch.Generator, dev) -> dict:
    """12b: ``forward`` with 2 x 256 patch embeddings and 64 tokens (640 rows
    per linear, counted); the same model cut to 2 layers at one request on
    the card against a CPU copy (rtol 1e-4 / atol 1e-4·max|x|); a prefix of
    zeros gives other logits than no prefix."""
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, VLM_TOKENS))).to(dev)
    patches = torch.randn((2, cfg.n_image_tokens, cfg.d_model), generator=gen).to(dev)
    logits, _ = counted_pass("12b forward", cfg.n_layers * 7, lambda: api.forward(
        cfg, params, {"tokens": toks, "patch_embeds": patches}))
    if tuple(logits.shape) != (2, VLM_TOKENS, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"12b forward: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    cut, card = cut_copy(cfg, params, 2)
    host = cm.tree_map(lambda t: t.to("cpu", copy=True), card)
    one = {"tokens": toks[:1], "patch_embeds": patches[:1]}
    worst = rel_close("12b card vs plain (2 layers)", api.forward(cut, card, one)[0],
                      api.forward(cut, host, cm.tree_map(lambda t: t.cpu(), one))[0])
    zeros = api.forward(cfg, params, {"tokens": toks[:1],
                                      "patch_embeds": torch.zeros_like(patches[:1])})[0]
    bare = tf.lm_forward(params, cfg, toks[:1])[0]
    diff = float((zeros - bare).abs().max())
    if torch.allclose(zeros, bare, rtol=1e-4, atol=1e-4 * float(bare.abs().max())):
        fail(f"12b: a prefix of zeros gives the logits of no prefix (max |d| {diff:.3g})")
    print(f"phase 12: internvl2 forward of 2 x ({cfg.n_image_tokens} image + {VLM_TOKENS} "
          f"token) rows, {cfg.n_layers * 7} matmul launches; cut to 2 layers at full width, the "
          f"card within rtol 1e-4 / atol 1e-4·max|x| of the CPU copy, max|d|/max|x| "
          f"{worst:.3g}; a prefix of zeros moves the logits by up to {diff:.3g} against no "
          f"prefix")
    return {"worst_rel_err": worst, "zero_prefix_max_abs_d": diff}


def encdec_requests(cfg) -> list[Request]:
    """Phase 12's requests: prompts of 4-16 tokens, m_active None and 1 in
    turn, 16 new tokens each."""
    rng = np.random.default_rng(5)
    return [Request(prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new_tokens=LM_NEW, m_active=(None, 1)[i % 2])
            for i, n in enumerate(rng.integers(4, 17, LM_BATCH))]


def serve_encdec(cfg, params, per_pass: int) -> dict:
    """Phase 12's main path: 8 requests through ``Server`` with token-wise
    admission (``per_pass`` matmul launches per admission step and per
    decode group step), then again on a fresh server: the same tokens and
    bit-equal logits."""
    reqs, srv, rounds, launches, serve_s = serve_twice("12", cfg, params, per_pass,
                                                       encdec_requests)
    if srv.stats["bulk_prefills"] or srv.stats["tokenwise_prefill_steps"] != sum(
            r.prompt.size - 1 for r in reqs):
        fail(f"12 serve {cfg.name}: admission was not token-wise: {srv.stats}")
    print(f"phase 12: {cfg.name} served {len(reqs)} requests (prompts "
          f"{[r.prompt.size for r in reqs]}, m_active None/1, token-wise admission) in {rounds} "
          f"rounds, {serve_s:.2f} s; stats {srv.stats}; {per_pass} matmul launches per "
          f"admission step and per decode group step; a second run gave the same tokens and "
          f"bit-equal logits")
    return {"stats": srv.stats, "rounds": rounds, "serve_s": serve_s, "launches": launches,
            "per_pass": per_pass, "prompt_lens": [int(r.prompt.size) for r in reqs],
            "out_tokens": [r.out_tokens for r in reqs]}


def encdec_step_work(cfg, params, srv) -> dict:
    """Bytes and operations one decode step at 8 slots must move and do:
    the weights it runs read once (whisper: the decoder's, less the cross
    k/v projections; the LM head's table), the 8 embedding rows, every
    cache leaf read (the self KV whole, whisper's cross K/V) and one self-KV
    row per slot and layer written, the logits written; operations 2 per
    MAC of the packed linears at 8 rows (fp-equivalent), of attention over
    the whole self cache and whisper's encoder rows, and of the LM head."""
    B, d, H, hd = LM_BATCH, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    if cfg.family == "encdec":
        dec = dict(params["dec_layers"])
        dec["xattn"] = {k: v for k, v in dec["xattn"].items() if k in ("wq", "wo")}
        serving = {"dec_layers": dec, "embed": params["embed"],
                   "final_norm": params["final_norm"]}
        self_kv = srv.cache["self"]
    else:
        serving = {k: v for k, v in params.items() if k != "embed"}
        self_kv = srv.cache["layers"]
    nbytes = nbytes_of(serving) + nbytes_of(srv.cache) + B * d * 4 + B * cfg.vocab * 4
    nbytes += sum(t[:, :, 0].numel() * t.element_size() for t in cm.tree_leaves(self_kv))
    W = self_kv["k"].shape[2]
    macs = packed_macs(serving, B) + B * cfg.vocab * d
    macs += cfg.n_layers * 2 * B * H * hd * (W + (cfg.encoder_len if cfg.family == "encdec"
                                                  else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": 2 * macs, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def encdec_timing(cfg, params, out_dir: Path) -> dict:
    """Phase 12 timings: admission of a 64-token prompt (token-wise), a
    decode step at 8 slots beside its bound, and for whisper a profiler
    window of 3 decode steps: device busy, idle share, and the device time
    of the matmul kernel, the cross-attention ops (those over the encoder's
    rows) and the LM head."""
    step, srv = decode_timing("phase 12", cfg, params, admit_reps=3)
    work = encdec_step_work(cfg, params, srv)
    step["work"] = work
    print(f"phase 12: {cfg.name} decode step bound {work['bound_ms']:.3f} ms "
          f"({work['bound_by']}: {work['bytes'] / 1e9:.2f} GB, {work['flops'] / 1e9:.1f} GFLOP) "
          f"against {step['decode_step_events_ms']:.3f} ms (CUDA events)")
    if cfg.family != "encdec":
        return step
    from torch.profiler import ProfilerActivity, profile, schedule
    path = out_dir / "trace_whisper.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=3, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(4):
            srv.step()
            torch.cuda.synchronize()
            prof.step()
    trace = path.read_text()
    with gzip.open(path.with_suffix(".json.gz"), "wt") as f:   # keeps chiprun_out/ small
        f.write(trace)
    path.unlink()
    path = path.with_suffix(".json.gz")
    split = device_split(json.loads(trace)["traceEvents"])
    parts = {
        "binary_matmul": sum(us for n, us in split["device_us_by_name"].items()
                             if "binary_matmul" in n),
        "cross_attention": self_device_us(prof, lambda ss: any(cfg.encoder_len in s
                                                               for s in ss)),
        "lm_head": self_device_us(prof, lambda ss: any(cfg.vocab in s for s in ss),
                                  ("aten::mm", "aten::bmm", "aten::addmm"))}
    if any(v == 0 for v in parts.values()):
        fail(f"12 profile {cfg.name}: device time by part {parts}")
    split.update({f"{k}_us_per_step": v / 3 for k, v in parts.items()})
    print(f"phase 12: profiler over 3 decode steps: window {split['window_us'] / 3e3:.4f} ms "
          f"per step, device busy {split['busy_us'] / 3e3:.4f} ms, idle share "
          f"{split['idle_share']:.4f}; per step: " + ", ".join(
              f"{k} {v / 3e3:.4f} ms" for k, v in parts.items()) +
          f"; trace {path.relative_to(ROOT)}")
    for name, us in list(split["device_us_by_name"].items())[:10]:
        print(f"  {us / 3e3:.5f} ms per step  {name[:110]}")
    return {**step, "profile": split}


def encdec_phase(gen: torch.Generator, dev, out_dir: Path) -> dict:
    """Phase 12: whisper-medium (a) and internvl2-2b (b) at their published
    widths and depths, then the reduced configs against a CPU copy (c)."""
    t0 = time.time()
    res = {"launches": {k: 0 for k in TPU_KERNELS}}
    for name in ENCDEC_ARCHS:
        t1 = time.time()
        cfg = encdec_config(name)
        params, build = build_encdec_lm(cfg, dev)
        weights = linear_weights(ENCDEC_LINEARS[name], params)
        rows = encdec_rows(cfg)
        r = {"config": {k: getattr(cfg, k) for k in (
                 "name", "family", "n_layers", "n_encoder_layers", "encoder_len",
                 "n_image_tokens", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                 "vocab", "activation", "tie_embeddings", "rope_theta", "dtype")} | {"M": 2},
             "build": build, "rows": rows,
             "plans": {label: {T: list(ops.pick_matmul_plan(T, w["B_packed"].shape[-1]))
                               for T in rows} for label, w in weights.items()},
             "max_abs_err": check_linear_kernels(f"phase 12 {name}", weights, rows, gen, dev)}
        rng = np.random.default_rng(7)
        if cfg.family == "encdec":
            per_pass = whisper_passes(cfg)["decode"]
            frames = torch.randn((LM_BATCH, cfg.encoder_len, cfg.d_model), generator=gen).to(dev)
            cache, r["encode"] = whisper_encode(cfg, params, frames)
            r["decode_vs_forward"] = whisper_decode_vs_forward(cfg, params, frames, cache, rng)
            del cache
            r["card_vs_plain"] = encdec_card_vs_plain(cfg, params, frames, rng)
            del frames
            row_counts = (LM_BATCH, LM_BUCKET, LM_BATCH * cfg.encoder_len)
        else:
            per_pass = cfg.n_layers * 7
            r["forward"] = vlm_forward(cfg, params, gen, dev)
            row_counts = (LM_BATCH, LM_BUCKET, 2 * (cfg.n_image_tokens + VLM_TOKENS))
        r["serve"] = serve_encdec(cfg, params, per_pass)
        r["timing"] = encdec_timing(cfg, params, out_dir)
        r["linears"] = time_linears(f"phase 12 {name}", weights, gen, dev, row_counts)
        r["seconds"] = time.time() - t1
        for k, v in r["serve"]["launches"].items():
            res["launches"][k] += v
        res[name] = r
        del params, weights
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 12: {name} {r['seconds']:.1f} s")
    res["reduced"] = {name: reduced_parity("12c", name, dev) for name in ENCDEC_ARCHS}
    res["train"] = {name: reduced_train("12c", name, dev) for name in ENCDEC_ARCHS}
    res["seconds"] = time.time() - t0
    print(f"phase 12: {res['seconds']:.1f} s; launches {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 13: the mesh (distributed/ over torch.distributed, several ranks on
# the one card through gloo)
# ---------------------------------------------------------------------------

MESH_SHAPES = {"cnn_a": (64, 48, 48, 3), "mobilenet": (16, 224, 224, 3)}
MESH_BD = tuple(f"pw{i}" for i in range(4, 13))
# (arch, (n_data, n_model)) -> (bd-sharded layers, per-device weight bytes,
# gather bytes, replication overhead): what the JAX package's
# repro.distributed.plan_mesh and mesh_totals give on the CPU for the same
# abstract programs (M=2, the default min_shard_bytes);
# tests/test_torch_distributed.py holds the two planners equal
MESH_STATIC = {
    ("mobilenet", (2, 1)): ((), 1_148_184, 0, 2.0),
    ("mobilenet", (1, 2)): (MESH_BD, 741_656, 28_901_376, 1.2918765633382803),
    ("mobilenet", (2, 2)): (MESH_BD, 741_656, 14_450_688, 2.5837531266765605),
    ("mobilenet", (1, 4)): (MESH_BD, 538_392, 43_352_064, 1.8756296900148408),
    ("cnn_a", (2, 1)): ((), 175_906, 0, 2.0),
    ("cnn_a", (4, 1)): ((), 175_906, 0, 4.0),
}
MESH_RUNS = {2: (("cnn_a", (2, 1)), ("mobilenet", (2, 1)), ("mobilenet", (1, 2))),
             4: (("mobilenet", (2, 2)),)}    # world size -> the plans its ranks run
MESH_SERVE = ("mobilenet", (1, 2))           # CNNService(mesh_plan=...), world 2
MESH_SERVE_BATCHES = 10
MESH_RAGGED = 15                             # MobileNet at 2x1 only
MESH_TIMED = 10


def mesh_static() -> dict:
    """13a: plan_mesh and verify_mesh_plan on the abstract programs."""
    quant = QuantConfig(mode="binary", M=2)
    abstract = {arch: deploy.abstract_program(arch, quant, shape, device="cpu")
                for arch, shape in MESH_SHAPES.items()}
    out = {}
    for (arch, (n_data, n_model)), want in MESH_STATIC.items():
        program = abstract[arch]
        plan = mesh_dist.plan_mesh(program, n_data=n_data, n_model=n_model)
        findings = verify_mesh_plan(program, plan)
        if findings:
            fail(f"mesh {arch} {n_data}x{n_model}: verify_mesh_plan: "
                 f"{[str(f) for f in findings]}")
        tot = mesh_dist.mesh_totals(program, plan)
        got = (tuple(program.instrs[i].name for i, s in enumerate(plan.shards)
                     if s.kind == "bd"),
               tot["per_device_weight_bytes"], tot["gather_bytes"],
               tot["replication_overhead"])
        if got != want:
            fail(f"mesh {arch} {n_data}x{n_model}: (bd layers, B/device, gather B, "
                 f"overhead) {got} != the JAX planner's {want}")
        out[f"{arch} {n_data}x{n_model}"] = tot
        print(f"phase 13a: {arch} {n_data}x{n_model}: verified clean, {len(got[0])} bd "
              f"layers, {got[1]} B/device, {got[2]} gather B, overhead {got[3]:.3f} "
              f"(the JAX planner's)")
    return out


def mesh_cases(program, arch: str, dev, ragged: bool):
    """(label, x, m_active) of each sharded forward: the compiled batch at
    m_active None, 1 and per layer, and the ragged batch (MobileNet 2x1)."""
    x = torch.randn(MESH_SHAPES[arch], generator=torch.Generator().manual_seed(13)).to(dev)
    per_layer = [1 + (i % 2) for i in range(len(program))]
    cases = [("none", x, None), ("one", x, 1), ("per_layer", x, per_layer)]
    if ragged:
        cases.append(("ragged", x[:MESH_RAGGED], per_layer))
    return cases


def mesh_images() -> np.ndarray:
    shape = (MESH_SERVE_BATCHES * SERVE_BATCH,) + MESH_SHAPES["mobilenet"][1:]
    return torch.randn(shape, generator=torch.Generator().manual_seed(14)).numpy()


def mesh_serve(program, plan, dev) -> tuple[torch.Tensor, dict]:
    """10 batches of 16 through CNNService (``mesh_plan=plan`` or None);
    returns the logits in request order and the launches of the path."""
    images = mesh_images()
    svc = CNNService(program, batch_size=SERVE_BATCH, max_queue=SERVE_BATCH,
                     mesh_plan=plan)
    logits = []
    ops.reset_launch_counts()
    for b in range(MESH_SERVE_BATCHES):
        reqs = [svc.submit(img) for img in images[b * SERVE_BATCH:(b + 1) * SERVE_BATCH]]
        svc.step()
        if any(r.status != "done" for r in reqs):
            raise RuntimeError(f"mesh service: {[r.status for r in reqs]}, {svc.stats}")
        logits.append(torch.stack([r.logits for r in reqs]))
    torch.cuda.synchronize()
    return torch.cat(logits), ops.launch_counts()


def mesh_rank(rank: int, world: int, ckpt_root: str, runs, serve, device: str) -> dict:
    """One rank of 13b-d on ``device``: load the saved programs, run each
    plan's sharded forwards with the launches and plan picks of each one
    gated, time the forward at the compiled batch (CUDA events) and, with
    ``serve``, run the mesh service."""
    dev = torch.device(device)
    quant = QuantConfig(mode="binary", M=2)
    programs = {}
    for arch in {a for a, _ in runs} | ({serve[0]} if serve else set()):
        like = deploy.abstract_program(arch, quant, MESH_SHAPES[arch], device=dev)
        programs[arch] = deploy.load_program(
            CheckpointManager(str(Path(ckpt_root) / arch), scrub=False), 0, like)
    out = {"logits": {}, "launches": {k: 0 for k in TPU_KERNELS}, "ms": {}}
    for arch, (n_data, n_model) in runs:
        program = programs[arch]
        plan = mesh_dist.plan_mesh(program, n_data=n_data, n_model=n_model)
        cases = mesh_cases(program, arch, dev,
                           ragged=(arch, n_data, n_model) == ("mobilenet", 2, 1))
        for label, x, m in cases:
            ops.reset_launch_counts()
            picks = ops.plan_pick_count()
            y = mesh_dist.execute_sharded(program, plan, x, m)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            if ops.plan_pick_count() != picks:
                raise RuntimeError(f"{arch} {n_data}x{n_model} {label}: "
                                   f"{ops.plan_pick_count() - picks} plan picks")
            if counts != EXPECTED_LAUNCHES[arch]:
                raise RuntimeError(f"{arch} {n_data}x{n_model} {label}: rank {rank} "
                                   f"launched {counts} != {EXPECTED_LAUNCHES[arch]}")
            for k, v in counts.items():
                out["launches"][k] += v
            out["logits"][(arch, n_data, n_model, label)] = y.cpu().numpy()
        x = cases[0][1]
        out["ms"][(arch, n_data, n_model)] = median_ms(
            lambda: mesh_dist.execute_sharded(program, plan, x))
    if serve:
        arch, (n_data, n_model) = serve
        plan = mesh_dist.plan_mesh(programs[arch], n_data=n_data, n_model=n_model)
        logits, counts = mesh_serve(programs[arch], plan, dev)
        out["serve"] = logits.numpy()
        want = {k: MESH_SERVE_BATCHES * v for k, v in EXPECTED_LAUNCHES[arch].items()}
        if counts != want:
            raise RuntimeError(f"mesh service: rank {rank} launched {counts} != {want}")
        for k, v in counts.items():
            out["launches"][k] += v
    out["cache"] = mesh_dist.cache_stats()
    return out


def median_ms(fn, warm: int = 2, reps: int = MESH_TIMED) -> float:
    """Median of ``reps`` calls after ``warm``, CUDA events around each call
    and a wait for its end (host work and collectives included)."""
    times = []
    for _ in range(warm + reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[warm:])


def mesh_phase(programs: dict, dev, out_dir: Path, smi: str) -> dict:
    """Phase 13: (a) the planner and verifier on the abstract programs;
    (b) phase 2-3's programs saved, loaded by ranks spawned on the one
    card (gloo) and run sharded, each forward torch.equal to single-process
    execute; (c) the mesh service against the plain one; (d) times."""
    t0 = time.time()
    res = {"static": mesh_static(), "backend": "gloo",
           "launches": {k: 0 for k in TPU_KERNELS}}
    ckpt_root = out_dir / "mesh_prog"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    for arch, program in programs.items():
        deploy.save_program(CheckpointManager(str(ckpt_root / arch)), 0, program)
    want = {(arch, label): deploy.execute(program, x, m).cpu()
            for arch, program in programs.items()
            for label, x, m in mesh_cases(program, arch, dev, ragged=arch == "mobilenet")}
    single = {}
    for arch, program in programs.items():
        x = mesh_cases(program, arch, dev, False)[0][1]
        single[arch] = median_ms(lambda: deploy.execute(program, x))
    plain_serve, _ = mesh_serve(programs[MESH_SERVE[0]], None, dev)
    checked, cache = 0, []
    for world, runs in MESH_RUNS.items():
        t1 = time.time()
        serve = MESH_SERVE if world == 2 else None
        per_rank = mesh_dist.run_local(world, mesh_rank, str(ckpt_root), runs, serve,
                                       str(dev), backend="gloo", device=str(dev),
                                       timeout_s=600)
        for rank, r in enumerate(per_rank):
            for (arch, n_data, n_model, label), y in r["logits"].items():
                y = torch.from_numpy(y)
                if not torch.equal(y, want[(arch, label)]):
                    d = float((y - want[(arch, label)]).abs().max())
                    fail(f"mesh {arch} {n_data}x{n_model} {label}: rank {rank} differs "
                         f"from single-process execute (max |d| {d:.3g})")
                checked += 1
            if serve and not torch.equal(torch.from_numpy(r["serve"]), plain_serve):
                fail(f"mesh service {serve}: rank {rank}'s answers differ from the "
                     f"single-process service's")
            for k, v in r["launches"].items():
                res["launches"][k] += v
            cache.append(r["cache"])
        for arch, (n_data, n_model) in runs:
            ms = per_rank[0]["ms"][(arch, n_data, n_model)]
            res[f"{arch} {n_data}x{n_model}"] = {"sharded_ms": ms, "single_ms": single[arch]}
            print(f"phase 13d: {arch} {n_data}x{n_model} at batch {MESH_SHAPES[arch][0]}: "
                  f"median sharded forward {ms:.3f} ms (rank 0, CUDA events) vs "
                  f"single-process execute {single[arch]:.3f} ms; gloo, all {world} ranks on "
                  f"one card: a correctness run that says nothing of scaling; {smi}")
        print(f"phase 13b: world {world}: {len(runs)} plans, {time.time() - t1:.1f} s")
    res["cache"] = cache
    res["seconds"] = time.time() - t0
    print(f"phase 13b: {checked} sharded forwards torch.equal to single-process execute, "
          f"no plan pick, one launch per instruction per rank; 13c: the mesh service "
          f"({MESH_SERVE[0]} {MESH_SERVE[1][0]}x{MESH_SERVE[1][1]}, {MESH_SERVE_BATCHES} "
          f"batches of {SERVE_BATCH}) equal to the plain one on both ranks; gloo's "
          f"all_gather took {dev.type} tensors")
    print(f"phase 13: {res['seconds']:.1f} s; launches {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 14: the sharded LM (sharding/, launch/{mesh,steps,pipeline}.py over
# DTensor; several ranks on the one card through gloo)
# ---------------------------------------------------------------------------

MESH_LM_STATIC = {"2x1": {"data": 2, "model": 1}, "1x2": {"data": 1, "model": 2},
                  "2x2": {"data": 2, "model": 2}, "16x16": {"data": 16, "model": 16}}
# world size -> its decode meshes, each with its layouts (FSDP or not; with
# one data rank FSDP splits nothing: 1x2 runs once)
MESH_LM_RUNS = {2: (((2, 1), (True, False)), ((1, 2), (True,))),
                4: (((2, 2), (True, False)),)}
MESH_LM_SLOTS, MESH_LM_LEN = 8, 128
MESH_LM_POS = (5, 17, 30, 64, 90, 100, 120, 127)      # each slot's position
MESH_LM_PREFILL = (2, 64)                             # rows x tokens, at 1x2
MESH_LM_TIMED = 1        # an FSDP step gathers the 1 GB fp32 table through the host: ~5 s
# (mesh, dtype, FSDP) cases held but not timed: their FSDP gathers through the
# host repeat those of the timed fp32 2x2 FSDP case
MESH_LM_UNTIMED = {((2, 1), "float32", True), ((2, 2), "bfloat16", True)}
MESH_LM_LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                   ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down"))  # call order
MESH_LM_BF16_RTOL = 2e-2          # tests/test_torch_mesh_lm.py's bf16 tolerance
MESH_TRAIN_DEPTH, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_LR = 2, 8, 64, 0.5
MESH_TRAIN_TOL = (1e-4, 1e-2)   # loss rtol, fake-quant update's L2 rtol over the whole tree
MESH_TRAIN_STEPS = 1            # the 2x1 Trainer's fake-quant steps before its save
MESH_TRAIN_DENSE_TOL = 1e-3     # each leaf's update against its own L2 (dense: no sign flips)
MESH_PIPE_X, MESH_PIPE_MICRO = (8, 64, 2048), 4
MESH_LM_PER_STEP = len(MESH_LM_LINEARS) * 18          # gemma-2b's binary linears per pass
MESH_SEQ_TOKENS = 512                                 # 14e: one prompt (B = 1)
MESH_SEQ_SHAPES = ((2, 1), (2, 2))                    # 14e's meshes, TP-only
MESH_COMPRESS_M = 2                                   # 14f: levels of the gradient
MESH_COMPRESS_NEAR = 1e-4     # |residual| within this·alpha of 0: a sign either way
MESH_COMPRESS_TOL = (1e-5, 1e-3)   # alphas' and recon's rtol; update's and error's L2 rtol
MESH_LM_BUDGET_S = 90                                 # the time phase 14 was planned to take


def mesh_lm_static(cfg) -> dict:
    """14a: the rules' specs for gemma-2b's fp and packed trees at 2x1, 1x2,
    2x2 and the production 16x16 (axis sizes only), and each rank's
    parameter bytes under them."""
    from repro_torch.sharding import rules as shr

    trees = {"fp": api.param_shapes(cfg), "packed": api.param_shapes(cfg, qc=cfg.quant)}
    out = {}
    for name, sizes in MESH_LM_STATIC.items():
        row = {}
        for kind, shapes in trees.items():
            total = nbytes_of(shapes)
            for fsdp in (True, False):
                specs = shr.param_pspecs(cfg, shapes, sizes, fsdp=fsdp)
                per_rank = 0
                for t, s in zip(cm.tree_leaves(shapes), cm.tree_leaves(specs)):
                    split = math.prod(sizes[a] for e in s if e for a in
                                      ((e,) if isinstance(e, str) else e))
                    per_rank += -(-t.numel() // split) * t.element_size()
                if per_rank * math.prod(sizes.values()) < total:
                    fail(f"mesh LM {name} {kind}: {per_rank} B per rank cannot hold {total} B")
                row[f"{kind} {'fsdp' if fsdp else 'tp'}"] = per_rank
        want = shr.P(None, None, ("data",), "model") if sizes["data"] > 1 else None
        got = shr.param_pspecs(cfg, trees["packed"], sizes)["layers"]["ffn"]["w_up"]["B_packed"]
        if want is not None and sizes["model"] > 1 and got != want:
            fail(f"mesh LM {name}: w_up's packed spec {got} != {want}")
        out[name] = row
        print(f"phase 14a: gemma-2b at {name}: parameter bytes per rank "
              + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in row.items())
              + f" (whole: fp {nbytes_of(trees['fp']) / 1e9:.3f} GB, packed "
              f"{nbytes_of(trees['packed']) / 1e9:.3f} GB)")
    return out


def mesh_lm_inputs(cfg, dev) -> dict:
    """The decode batch: tokens, each slot's position and a cache of random
    keys and values (the same in every process: drawn on the host)."""
    gen = torch.Generator().manual_seed(14)
    cache = cm.tree_map(lambda s: torch.randn(s.shape, generator=gen).to(dev, s.dtype),
                        api.cache_specs(cfg, MESH_LM_SLOTS, MESH_LM_LEN))
    return {"tokens": torch.randint(0, cfg.vocab, (MESH_LM_SLOTS, 1), generator=gen,
                                    dtype=torch.int32).to(dev),
            "pos": torch.tensor(MESH_LM_POS, dtype=torch.int32).to(dev), "cache": cache}


def bf16_tree(cfg, packed):
    """``cfg`` and its packed tree in bf16 (the embedding and norms cast;
    the packed bits and fp32 alphas kept, as binarize makes them)."""
    return cfg.replace(dtype="bfloat16"), cm.tree_map(
        lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 and t.ndim < 4 else t,
        packed)


@contextlib.contextmanager
def recorded_matmuls(calls: list):
    """``ops.binary_matmul`` recording each call's (x, B, alpha, kw, y)."""
    real = ops.binary_matmul

    def rec(x, B_packed, alpha, **kw):
        y = real(x, B_packed, alpha, **kw)
        calls.append((x, B_packed, alpha, kw, y))
        return y
    ops.binary_matmul = rec
    try:
        yield
    finally:
        ops.binary_matmul = real


def linears_vs_single(calls: list, full: dict, mesh) -> int:
    """Each recorded linear of a step (layer by layer, in MESH_LM_LINEARS'
    order) against the single-process kernel on the whole weight and the
    same rows: the rank's columns ``torch.equal`` to the same columns of
    the whole output (so the gather over ``"model"`` equals it)."""
    if len(calls) != len(MESH_LM_LINEARS) * full["layers"]["ln1"]["scale"].shape[0]:
        raise RuntimeError(f"{len(calls)} binary linears in a step")
    col = mesh.get_local_rank("model")
    for i, (x, B, alpha, kw, y) in enumerate(calls):
        a, w = MESH_LM_LINEARS[i % len(MESH_LM_LINEARS)]
        lin = full["layers"][a][w]
        l = i // len(MESH_LM_LINEARS)
        whole = ops.binary_matmul(x, lin["B_packed"][l], lin["alpha"][l], **kw)
        n = B.shape[-1]
        if not torch.equal(y, whole[..., col * n:(col + 1) * n]):
            d = float((y - whole[..., col * n:(col + 1) * n]).abs().max())
            raise RuntimeError(f"layer {l} {a}/{w}: the rank's columns differ from the "
                               f"single-process kernel's (max |d| {d:.3g})")
    return len(calls)


def counted_step(fn) -> tuple:
    """``fn()`` with the matmul launches it made."""
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()["binary_matmul"]


def close_to(where: str, got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """rtol / atol rtol·max|want|; returns max|d| / max|want|."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or not torch.allclose(got, want, rtol=rtol,
                                                                  atol=rtol * scale):
        raise RuntimeError(f"{where}: max |d| {err:.3g}, max |x| {scale:.3g}")
    return err / scale


def gathered_weight_bytes(cfg, full, mesh_shape, fsdp: bool) -> int:
    """Weight bytes a rank receives per step from the FSDP gathers: each
    FSDP-split leaf's (the ``B_packed``s' and the embedding table's) part
    on the rank's model coordinate, less the rank's own share."""
    n_data, n_model = mesh_shape
    if not fsdp or n_data == 1:
        return 0
    from repro_torch.sharding import rules as shr

    specs = shr.param_pspecs(cfg, full, {"data": n_data, "model": n_model})
    total = 0
    for t, s in zip(cm.tree_leaves(full), cm.tree_leaves(specs)):
        if any(e == ("data",) for e in s):
            total += t.numel() * t.element_size() // n_model * (n_data - 1) // n_data
    return total


def decode_case(cfg, full, mesh, shape, fsdp: bool, dev, rtol: float = 1e-4) -> dict:
    """One decode step of ``cfg`` on ``mesh``: launches, the linears against
    the single-process kernel, the logits against single-process
    ``api.decode_step`` in this process, then MESH_LM_TIMED timed steps
    (none for a case of MESH_LM_UNTIMED)."""
    t0 = time.time()
    where = f"{shape[0]}x{shape[1]} {cfg.dtype} fsdp={fsdp}"
    step = train_steps.build_serve_step(cfg, mesh, fsdp_params=fsdp)
    params = step.shard_params(full)
    inputs = mesh_lm_inputs(cfg, dev)
    want, _ = api.decode_step(cfg, full, dict(inputs, cache=cm.tree_map(torch.clone,
                                                                        inputs["cache"])))
    batch = step.shard_batch(inputs)
    calls = []
    with recorded_matmuls(calls):
        (logits, _), n = counted_step(lambda: step(params, batch))
    launches = [n]
    checked = linears_vs_single(calls, full, mesh)
    del calls
    err = close_to(f"mesh LM decode {where}: logits vs single-process",
                   logits.full_tensor(), want, rtol)
    times = []
    for _ in range(0 if (shape, cfg.dtype, fsdp) in MESH_LM_UNTIMED else MESH_LM_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, n = counted_step(lambda: step(params, batch))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        launches.append(n)
    if any(n != MESH_LM_PER_STEP for n in launches):
        raise RuntimeError(f"mesh LM decode {where}: launches per step {launches}, "
                           f"want {MESH_LM_PER_STEP}")
    return {"launches": sum(launches), "linears_equal": checked, "logit_err": err,
            "step_ms": statistics.median(times) if times else None,
            "gathered_weight_bytes": gathered_weight_bytes(cfg, full, shape, fsdp),
            "seconds": time.time() - t0}


def prefill_case(cfg, full, mesh, shape, dev) -> dict:
    """One prefill forward (MESH_LM_PREFILL) on ``mesh`` against
    single-process ``api.forward``."""
    step = train_steps.build_serve_step(cfg, mesh, kind="prefill")
    rows, n_tok = MESH_LM_PREFILL
    tokens = torch.randint(0, cfg.vocab, (rows, n_tok), generator=torch.Generator()
                           .manual_seed(15), dtype=torch.int32).to(dev)
    want, _ = api.forward(cfg, full, {"tokens": tokens})
    calls = []
    with recorded_matmuls(calls):
        logits, n = counted_step(lambda: step(step.shard_params(full),
                                              step.shard_batch({"tokens": tokens})))
    if n != MESH_LM_PER_STEP:
        raise RuntimeError(f"mesh LM prefill {shape}: {n} launches, want {MESH_LM_PER_STEP}")
    checked = linears_vs_single(calls, full, mesh)
    del calls
    err = close_to(f"mesh LM prefill {shape}: logits vs single-process", logits.full_tensor(),
                   want, 1e-4)
    return {"launches": n, "linears_equal": checked, "logit_err": err}


def pipeline_case(cfg, full, mesh, dev) -> dict:
    """14d: two stages of one full-width packed gemma layer each through
    ``pipeline_apply`` against ``reference_apply``."""
    from repro_torch.launch import pipeline as lpipe

    stages = cm.tree_map(lambda t: t[:2], full["layers"])
    x = torch.randn(MESH_PIPE_X, generator=torch.Generator().manual_seed(16)).to(dev)

    def stage_fn(p, h):
        return tf.layer_forward(p, h, cfg)[0]
    y, n = counted_step(lambda: lpipe.pipeline_apply(stage_fn, stages, x, mesh=mesh,
                                                     n_micro=MESH_PIPE_MICRO))
    want_n = (MESH_PIPE_MICRO + 1) * len(MESH_LM_LINEARS)
    if n != want_n:
        raise RuntimeError(f"pipeline: {n} launches on this rank, want {want_n}")
    err = close_to("pipeline vs reference_apply", y,
                   lpipe.reference_apply(stage_fn, stages, x), 1e-4)
    return {"launches": n, "err": err}


def mesh_train_config():
    """gemma-2b at full width cut to MESH_TRAIN_DEPTH layers, fp32,
    fake-quant M=2 linears."""
    return get_config("gemma_2b").replace(
        n_layers=MESH_TRAIN_DEPTH, dtype="float32",
        quant=QuantConfig(mode="fake_quant", M=2, K_iters=8))


def train_case(dev, meshes: dict, ckpt_dir: str) -> dict:
    """14c: gemma-2b cut to MESH_TRAIN_DEPTH layers, SGD with momentum (the
    update follows the gradient).  Dense: one step at 2x1 and one at 1x2
    against one single-process step, each leaf's update within
    MESH_TRAIN_DENSE_TOL of its own L2 (a wrong gradient on any leaf, a
    norm scale's too, shows; the whole tree's L2 would hide a small leaf).
    Fake-quant M=2: a Trainer's MESH_TRAIN_STEPS step(s) at 2x1 that then
    saves, against as many single-process steps within MESH_TRAIN_TOL
    (Algorithm 2 solves alpha over the rank's columns, and a residual
    within rounding of 0 takes another sign there, which moves W_hat by
    2·alpha; each leaf's worst ratio is reported); a Trainer at 1x2 that
    resumes from the save (restore(shardings=): params and momenta
    torch.equal to the saved ones), whose step function then runs one step
    more, held against a further single-process step the same way
    (``Trainer.run`` would save again: 6.3 GB through one card's gloo,
    which the CPU test covers)."""
    from repro_torch.optim import sgd

    cfg = mesh_train_config()
    dense = cfg.replace(quant=cfg.quant.replace(mode="dense"))
    opt = sgd(MESH_TRAIN_LR)
    loss_rtol, update_rtol = MESH_TRAIN_TOL

    def data():
        return SyntheticTokens(cfg.vocab, MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, device=dev)

    def trainer(mesh, total):
        return Trainer(train_steps.build_train_step(cfg, opt, mesh=mesh),
                       train_steps.init_train_state(cfg, opt, device=dev, mesh=mesh),
                       data(), TrainerConfig(total_steps=total,
                                             checkpoint_every=MESH_TRAIN_STEPS,
                                             checkpoint_dir=ckpt_dir, log_every=1000),
                       state_shardings=train_steps.train_state_shardings(cfg, mesh, opt))

    def run(c, mesh, n):
        """n steps from the seeded init: the losses and the params after each
        of the last two."""
        state = train_steps.init_train_state(c, opt, device=dev, mesh=mesh)
        fn, src, losses, params = train_steps.build_train_step(c, opt, mesh=mesh), data(), [], []
        for i in range(n):
            state, met = fn(state, src.next_batch())
            losses.append(float(met["loss"]))
            if i >= n - 2:
                params.append(cm.tree_map(torch.clone, state["params"]))
        return params, losses

    def l2(x, y):
        return float(torch.linalg.vector_norm(pl.full(x) - y, dtype=torch.float64))

    def whole(a, b):
        """||a - b|| in L2 over the whole tree."""
        return sum(l2(x, y) ** 2 for x, y in zip(cm.tree_leaves(a), cm.tree_leaves(b))) ** 0.5

    def worst_leaf(got, want, init):
        """The largest ||got - want|| / ||want - init|| over the leaves."""
        return max(l2(g, w) / max(l2(w, i), 1e-30) for g, w, i in
                   zip(*(cm.tree_leaves(t) for t in (got, want, init))))

    init = cm.tree_map(torch.clone, train_steps.init_train_state(cfg, opt, device=dev)["params"])
    out = {}
    t0 = time.time()
    (ref,), ref_losses = run(dense, None, 1)
    out["dense"] = {"ref_losses": ref_losses}
    for shape in ((2, 1), (1, 2)):
        (params,), losses = run(dense, meshes[shape], 1)
        worst = worst_leaf(params, ref, init)
        if not (np.allclose(losses, ref_losses, rtol=loss_rtol)
                and worst <= MESH_TRAIN_DENSE_TOL):
            raise RuntimeError(f"mesh train dense {shape}: losses {losses} vs {ref_losses}; a "
                               f"leaf {worst:.3g} of its own update from single-process")
        out["dense"][f"{shape[0]}x{shape[1]}"] = {"losses": losses, "worst_leaf": worst}
        del params
    out["dense"]["seconds"] = time.time() - t0
    t0 = time.time()
    (ref_saved, ref_next), ref_losses = run(cfg, None, MESH_TRAIN_STEPS + 1)
    out.update(ref_losses=ref_losses, ref_s=time.time() - t0)

    def check(shape, params, losses, ref, seconds):
        n = len(losses)
        update = whole(ref, init)
        err = whole(params, ref)
        if not (np.allclose(losses, ref_losses[:n], rtol=loss_rtol)
                and err <= update_rtol * update):
            raise RuntimeError(f"mesh train {shape}: losses {losses} vs {ref_losses[:n]}; params "
                               f"{err:.3g} (L2) from single-process, the update's L2 "
                               f"{update:.3g}")
        out[f"{shape[0]}x{shape[1]}"] = {
            "steps": n, "losses": losses, "update_l2": update,
            "param_err_over_update": err / update,
            "worst_leaf": worst_leaf(params, ref, init), "seconds": seconds}

    t0 = time.time()
    first = trainer(meshes[(2, 1)], MESH_TRAIN_STEPS)
    report = first.run()
    out["save_s"] = time.time() - t0
    # gathered once: each gather of the state goes through the host (gloo)
    saved = {k: cm.tree_map(pl.full, first.state[k]) for k in ("params", "opt_state")}
    check((2, 1), saved["params"], report.losses, ref_saved, out["save_s"])
    del first, ref_saved
    t0 = time.time()
    second = trainer(meshes[(1, 2)], MESH_TRAIN_STEPS + 1)
    if not second.maybe_resume() or second.report.resumed_from != MESH_TRAIN_STEPS:
        raise RuntimeError(f"mesh train: the 1x2 Trainer did not resume from step "
                           f"{MESH_TRAIN_STEPS}")
    for a, b in zip(cm.tree_leaves(saved), cm.tree_leaves(
            {k: second.state[k] for k in ("params", "opt_state")})):
        # the rank's shard against the same shard of the saved state
        if tuple(b.device_mesh.shape) != (1, 2) or not torch.equal(
                pl.place(a, b.device_mesh, b.placements).to_local(), b.to_local()):
            raise RuntimeError("mesh train: the state restored onto 1x2 differs from the "
                               "state saved at 2x1")
    del saved
    out["restore_s"] = time.time() - t0
    t0 = time.time()
    second.state, met = second.step_fn(second.state, second.data.next_batch())
    if int(second.state["step"]) != MESH_TRAIN_STEPS + 1:
        raise RuntimeError(f"mesh train: the resumed step ended at step "
                           f"{int(second.state['step'])}")
    check((1, 2), cm.tree_map(pl.full, second.state["params"]),
          report.losses + [float(met["loss"])], ref_next, time.time() - t0)
    return out


def local_part(whole: torch.Tensor, like) -> torch.Tensor:
    """The part of ``whole`` (a tensor of ``like``'s global shape) that
    this rank holds of the DTensor ``like``: a view, on ``whole``'s
    device."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    n, off = compute_local_shape_and_global_offset(like.shape, like.device_mesh, like.placements)
    return whole[tuple(slice(o, o + k) for o, k in zip(off, n))]


def seq_prefill_case(cfg, full, mesh, shape, dev) -> dict:
    """14e: one prompt of MESH_SEQ_TOKENS tokens (B = 1) through the
    sequence-sharded packed prefill on ``mesh``, TP-only: every kernel call
    on the rank's rows of the sequence, its output ``torch.equal`` to the
    single-process prefill kernel's at the same rows and columns (a
    single-process call runs all the rows at another plan: the kernel is
    bit-identical across plans), the rank's logits within
    1e-4·max|logit| of the same part of single-process ``api.forward``'s;
    then one timed pass of each (CUDA events)."""
    n_data, n_model = shape
    seq, col = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    rows = MESH_SEQ_TOKENS // n_data
    tokens = torch.randint(0, cfg.vocab, (1, MESH_SEQ_TOKENS), generator=torch.Generator()
                           .manual_seed(17), dtype=torch.int32).to(dev)
    want_rows, real = [], ops.binary_matmul

    def keep(x, B_packed, alpha, **kw):
        y = real(x, B_packed, alpha, **kw)
        n = B_packed.shape[-1] // n_model
        want_rows.append(y[:, seq * rows:(seq + 1) * rows, col * n:(col + 1) * n].clone())
        return y
    ops.binary_matmul = keep
    try:
        want, _ = api.forward(cfg, full, {"tokens": tokens})
    finally:
        ops.binary_matmul = real
    step = train_steps.build_serve_step(cfg, mesh, kind="prefill", fsdp_params=False,
                                        seq_sharded=True)
    params, batch = step.shard_params(full), step.shard_batch({"tokens": tokens})
    calls = []
    with recorded_matmuls(calls):
        logits, n = counted_step(lambda: step(params, batch))
    where = f"mesh LM sequence-sharded prefill {shape[0]}x{shape[1]}"
    if n != MESH_LM_PER_STEP or len(calls) != len(want_rows):
        raise RuntimeError(f"{where}: {n} launches, {len(calls)} calls, want "
                           f"{MESH_LM_PER_STEP} and {len(want_rows)}")
    for i, ((x, _, _, _, y), w) in enumerate(zip(calls, want_rows)):
        a, lin = MESH_LM_LINEARS[i % len(MESH_LM_LINEARS)]
        if tuple(x.shape[:2]) != (1, rows):
            raise RuntimeError(f"{where}: layer {i // len(MESH_LM_LINEARS)} {a}/{lin} ran on "
                               f"rows {tuple(x.shape)}")
        if not torch.equal(y, w):
            raise RuntimeError(f"{where}: layer {i // len(MESH_LM_LINEARS)} {a}/{lin}: the rank's "
                               f"rows differ from the single-process kernel's (max |d| "
                               f"{float((y - w).abs().max()):.3g})")
    del calls, want_rows
    loc, part = logits.to_local(), local_part(want, logits)
    scale = float(want.abs().max())
    err = float((loc - part).abs().max())
    if not bool(torch.isfinite(loc).all()) or not torch.allclose(loc, part, rtol=1e-4,
                                                                  atol=1e-4 * scale):
        raise RuntimeError(f"{where}: logits max |d| {err:.3g}, max |logit| {scale:.3g}")
    del want, part, logits, loc

    def timed(fn) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    single_ms = timed(lambda: api.forward(cfg, full, {"tokens": tokens}))
    ops.reset_launch_counts()
    mesh_ms = timed(lambda: step(params, batch))
    n_timed = ops.launch_counts()["binary_matmul"]
    if n_timed != MESH_LM_PER_STEP:
        raise RuntimeError(f"{where}: the timed pass made {n_timed} launches")
    return {"launches": n + n_timed, "rows": rows, "linears_equal": MESH_LM_PER_STEP,
            "logit_err": err / scale, "ms": mesh_ms, "single_ms": single_ms}


@contextlib.contextmanager
def recorded_compress(records: list):
    """``core.compress.compress_leaf`` keeping, per leaf, a copy of its
    reconstruction (the optimizer's clip scales the one it is given in
    place), its alphas and its input ``g + e`` (a DTensor leaf's: the
    rank's shards)."""
    from repro_torch.core import compress as gcomp

    real = gcomp.compress_leaf

    def leaf(g, e, M):
        recon, resid, alphas = real(g, e, M)
        records.append({"recon": pl.local(recon).clone(), "alphas": alphas,
                        "target": pl.local(g).to(torch.float32) + pl.local(e)})
        return recon, resid, alphas
    gcomp.compress_leaf = leaf
    try:
        yield
    finally:
        gcomp.compress_leaf = real


def near_sign_change(target, alphas, diff) -> torch.Tensor:
    """Where the residual of ``target`` at some level lies within
    MESH_COMPRESS_NEAR·alpha of 0, or within ``diff`` (the other side's
    input's distance from this one) of 0: there the two sides may take
    different signs."""
    r = target
    near = torch.zeros(r.shape, dtype=torch.bool, device=r.device)
    for a in alphas:
        near |= r.abs() <= MESH_COMPRESS_NEAR * a + diff
        r = r - a * torch.where(r >= 0, 1.0, -1.0)
    return near


def compressed_case(dev, meshes: dict) -> dict:
    """14f: 14c's 2-layer cut, dense, SGD with momentum, one step with
    binary gradient compression (MESH_COMPRESS_M levels) at 2x1 and one
    at 1x2 against one single-process compressed step from the same
    params and batch.  Per leaf: the alphas within rtol
    MESH_COMPRESS_TOL[0]; the rank's shard of the reconstructed gradient
    within MESH_COMPRESS_TOL[0]·sum(alpha) of the same shard of
    single-process's (every sign the same), except where the
    single-process residual at some level lay within
    MESH_COMPRESS_NEAR·alpha of 0, or within the two sides' own gradient
    difference at that element of 0 (:func:`near_sign_change`: a sum in
    another order may take the other sign there; counted, with the signs
    that did differ); elsewhere the rank's update (params after the step)
    and error state within MESH_COMPRESS_TOL[1] of their own L2.  (On the
    card the mesh's gradient differs from single-process's by up to ~1e-4
    of a leaf in L2, 14c's dense gate measures it, and by a few 1e-3
    relative at single elements: more than MESH_COMPRESS_NEAR·alpha.)
    Every comparison is shard against shard: nothing is gathered."""
    from repro_torch.core import compress as gcomp
    from repro_torch.optim import sgd

    cfg = mesh_train_config()
    cfg = cfg.replace(quant=cfg.quant.replace(mode="dense"))
    opt = sgd(MESH_TRAIN_LR)
    rtol, l2_rtol = MESH_COMPRESS_TOL

    def one_step(mesh):
        state = train_steps.init_train_state(cfg, opt, device=dev, mesh=mesh)
        state["grad_comp"] = gcomp.init_state(state["params"])
        fn = train_steps.build_train_step(cfg, opt, grad_compress_M=MESH_COMPRESS_M, mesh=mesh)
        records = []
        t0 = time.time()
        with recorded_compress(records):
            state, met = fn(state, SyntheticTokens(cfg.vocab, MESH_TRAIN_SEQ, MESH_TRAIN_BATCH,
                                                   device=dev).next_batch())
        torch.cuda.synchronize()
        return state, float(met["loss"]), records, time.time() - t0

    ref, ref_loss, ref_rec, ref_s = one_step(None)
    out = {"ref_loss": ref_loss, "ref_s": ref_s}
    # the records come in the tree's insertion order, tree_leaves in sorted order
    order = iter(range(len(ref_rec)))
    by_leaf = cm.tree_leaves(cm.tree_map(lambda _: next(order), ref["params"]))
    # the reference waits on the host (each rank holds one; on the card two
    # whole copies beside the mesh steps' state run the card out of memory)
    ref = [[t.cpu() for t in cm.tree_leaves(tree)] for tree in
           (ref["params"], ref["grad_comp"].error, ref["opt_state"]["vel"])]
    ref_rec = [{k: v.cpu() for k, v in ref_rec[j].items()} for j in by_leaf]
    torch.cuda.empty_cache()

    def sq_over_shards(x, like) -> float:
        return float(pl.sum_over_shards(torch.linalg.vector_norm(x) ** 2, like))

    for shape in ((2, 1), (1, 2)):
        mesh = meshes[shape]
        state, loss, rec, secs = one_step(mesh)
        where = f"mesh train compressed {shape[0]}x{shape[1]}"
        if len(rec) != len(ref_rec) or not np.isclose(loss, ref_loss, rtol=1e-4):
            raise RuntimeError(f"{where}: {len(rec)} leaves vs {len(ref_rec)}, loss {loss} vs "
                               f"{ref_loss}")
        leaves = zip([rec[k] for k in by_leaf], ref_rec, cm.tree_leaves(state["params"]),
                     cm.tree_leaves(state["grad_comp"].error), *ref)
        flagged = by_alpha = flipped = beyond = n_elems = 0
        worst = {"alpha": 0.0, "input": 0.0, "update": 0.0, "error": 0.0}
        for i, (m, r, p, e, p_ref, e_ref, v_ref) in enumerate(leaves):
            def mine(t):        # the host reference's part on this rank, on the card
                return local_part(t, p).to(dev)
            alphas = r["alphas"].to(dev)
            a_err = float(((m["alphas"] - alphas).abs() / alphas.abs()).max())
            worst["alpha"] = max(worst["alpha"], a_err)
            target = mine(r["target"])
            diff = (m["target"] - target).abs()
            near_alpha = near_sign_change(target, alphas, 0)
            keep = ~near_sign_change(target, alphas, diff)
            worst["input"] = max(worst["input"], (sq_over_shards(diff, p) / max(
                sq_over_shards(target, p), 1e-60)) ** 0.5)
            del diff
            got, want = m["recon"], mine(r["recon"])
            # recon = sum_l b_l·alpha_l: with every sign the same it moves by
            # at most rtol·sum(alpha) (a sign taken otherwise moves it by
            # 2·alpha_l); a relative bound would fail where b_1 = -b_2 makes
            # it alpha_1 - alpha_2
            atol = rtol * float(alphas.sum())
            d = (got - want).abs_()
            flips = d > atol
            if a_err > rtol or bool((flips & keep).any()):
                j = int(torch.argmax(d.masked_fill_(~keep, 0).flatten()))
                raise RuntimeError(
                    f"{where}: leaf {i} {tuple(p.shape)}: alphas {alphas.tolist()} vs "
                    f"{m['alphas'].tolist()} ({a_err:.3g} apart), recon max |d| "
                    f"{float(d.flatten()[j]):.3g} at {int((flips & keep).sum())} elements; "
                    f"the worst: recon {float(got.flatten()[j])} vs {float(want.flatten()[j])}, "
                    f"g + e {float(m['target'].flatten()[j])} vs {float(target.flatten()[j])}")
            del d, want, target
            flagged += int(pl.sum_over_shards((~keep).sum(), p))
            by_alpha += int(pl.sum_over_shards(near_alpha.sum(), p))
            flipped += int(pl.sum_over_shards(flips.sum(), p))
            beyond += int(pl.sum_over_shards((flips & ~near_alpha).sum(), p))
            del flips, near_alpha
            n_elems += p.numel()
            for name, x, x_ref, own in (("update", pl.local(p), p_ref, v_ref),
                                        ("error", pl.local(e), e_ref, e_ref)):
                err = sq_over_shards((x - mine(x_ref)).masked_fill_(~keep, 0), p) ** 0.5
                size = sq_over_shards(mine(own).masked_fill_(~keep, 0), p) ** 0.5
                if name == "update":        # SGD's first step moves a param by lr·vel
                    size *= MESH_TRAIN_LR
                ratio = err / max(size, 1e-30)
                worst[name] = max(worst[name], ratio)
                if ratio > l2_rtol:
                    raise RuntimeError(f"{where}: leaf {i} {tuple(p.shape)}: {name} {ratio:.3g} "
                                       f"of its own L2 from single-process")
        out[f"{shape[0]}x{shape[1]}"] = {"loss": loss, "flagged": flagged, "by_alpha": by_alpha,
                                         "flipped": flipped, "flipped_beyond_alpha": beyond,
                                         "elements": n_elems,
                                         "worst": worst, "seconds": secs}
        del state, rec
        torch.cuda.empty_cache()
    return out


def mesh_lm_rank(rank: int, world: int, ckpt_dir: str, runs, device: str) -> dict:
    """One rank of 14b-d: the packed gemma-2b restored whole onto the card,
    each mesh of ``runs``' decode steps (fp32 in its layouts; bf16 too at
    2x2), at world 2 the 1x2 prefill, the pipeline and the train step."""
    import faulthandler

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import pipeline as lpipe

    faulthandler.enable()       # a crash in a collective names its frame
    dev = torch.device(device)
    cfg = lm_config()
    like = cm.tree_map(lambda t: torch.empty((), dtype=t.dtype, device=dev).expand(t.shape),
                       api.param_shapes(cfg, qc=cfg.quant))
    t0 = time.time()
    full, _ = CheckpointManager(ckpt_dir, scrub=False).restore(0, like)
    out = {"decode": {}, "launches": 0, "restore_s": time.time() - t0}
    for shape, layouts in runs:
        mesh = lmesh.make_host_mesh(shape[1], device=dev)
        for fsdp in layouts:
            r = decode_case(cfg, full, mesh, shape, fsdp, dev)
            out["decode"][(shape, "float32", fsdp)] = r
            out["launches"] += r["launches"]
        if shape == (2, 2):
            cfg16, full16 = bf16_tree(cfg, full)
            for fsdp in layouts:
                r = decode_case(cfg16, full16, mesh, shape, fsdp, dev, rtol=MESH_LM_BF16_RTOL)
                out["decode"][(shape, "bfloat16", fsdp)] = r
                out["launches"] += r["launches"]
            del full16
        if shape == (1, 2):
            out["prefill"] = prefill_case(cfg, full, mesh, shape, dev)
            out["launches"] += out["prefill"]["launches"]
        if shape in MESH_SEQ_SHAPES:
            t0 = time.time()
            r = out.setdefault("seq", {})[shape] = seq_prefill_case(cfg, full, mesh, shape, dev)
            r["seconds"] = time.time() - t0
            out["launches"] += r["launches"]
    if world == 2:
        out["pipeline"] = pipeline_case(cfg, full, lpipe.make_pipeline_mesh(2, device=dev), dev)
        out["launches"] += out["pipeline"]["launches"]
        del full
        torch.cuda.empty_cache()
        meshes = {(2, 1): lmesh.make_host_mesh(1, device=dev),
                  (1, 2): lmesh.make_host_mesh(2, device=dev)}
        t0 = time.time()
        out["train"] = train_case(dev, meshes, str(Path(ckpt_dir).parent / "train"))
        out["train"]["seconds"] = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        out["compressed"] = compressed_case(dev, meshes)
        out["compressed"]["seconds"] = time.time() - t0
    return out


def mesh_lm_phase(dev, out_dir: Path, smi: str, after_timing) -> dict:
    """Phase 14: (a) the rules' specs and per-rank bytes; (b) the packed
    gemma-2b built (phase 7's build), saved, and restored by ranks spawned
    on the one card (gloo), whose sharded decode steps hold each linear
    ``torch.equal`` to the single-process kernel and the logits to
    single-process ``decode_step``, 126 launches per rank per step; (c) the
    mesh train step, save at 2x1 and restore onto 1x2; (d) the pipeline.
    ``after_timing()`` is called once the single-process step is timed."""
    t0 = time.time()
    cfg = lm_config()
    res = {"static": mesh_lm_static(cfg), "backend": "gloo"}
    params, info = build_lm(cfg, dev, "phase 14b")
    res["build_s"] = info["build_s"]
    inputs = mesh_lm_inputs(cfg, dev)
    single = median_ms(lambda: api.decode_step(cfg, params, inputs), reps=MESH_LM_TIMED)
    after_timing()
    res["counter"] = counter_on_card(cfg, params, inputs, single, smi)
    # the checkpoints (2.6 GB packed, 6.3 GB of train state) live only as
    # long as the phase: chiprun_out/ comes back from the card whole
    tmp = tempfile.TemporaryDirectory(dir=out_dir, prefix="mesh_lm_")
    ckpt = Path(tmp.name)
    t1 = time.time()
    CheckpointManager(str(ckpt / "packed")).save(0, params)
    res["save_s"] = time.time() - t1
    res["single_step_ms"] = single
    del params, inputs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 14b: packed gemma-2b built in {info['build_s']:.1f} s and saved in "
          f"{res['save_s']:.1f} s; single-process decode step at {MESH_LM_SLOTS} slots "
          f"{single:.3f} ms (median of {MESH_LM_TIMED}, CUDA events); {smi}")
    res["launches"] = {k: 0 for k in TPU_KERNELS}
    for world, runs in MESH_LM_RUNS.items():
        t1 = time.time()
        per_rank = mesh_dist.run_local(world, mesh_lm_rank, str(ckpt / "packed"), runs,
                                       str(dev), backend="gloo", device=str(dev),
                                       timeout_s=900)
        for r in per_rank:
            res["launches"]["binary_matmul"] += r["launches"]
        for (shape, dtype, fsdp), r in per_rank[0]["decode"].items():
            key = f"{shape[0]}x{shape[1]} {dtype} {'fsdp' if fsdp else 'tp'}"
            res[key] = r
            print(f"phase 14b: {key}: {MESH_LM_PER_STEP} launches per rank per step, "
                  f"{r['linears_equal']} linears torch.equal to the single-process kernel, "
                  f"logits {r['logit_err']:.3g}·max|logit| from single-process; "
                  + (f"median step {r['step_ms']:.1f} ms on rank 0" if r["step_ms"] is not None
                     else "not timed (its gathers repeat 2x2 fp32 FSDP's)")
                  + f" vs single-process {single:.3f} ms; "
                  f"FSDP weights gathered per rank per step (packed linears and the fp32 "
                  f"embedding table) {r['gathered_weight_bytes'] / 1e6:.1f} MB; gloo, all "
                  f"{world} ranks on one card: says nothing of scaling; case "
                  f"{r['seconds']:.1f} s; {smi}")
        if "prefill" in per_rank[0]:
            r = per_rank[0]["prefill"]
            res["prefill 1x2"] = r
            print(f"phase 14b: prefill of {MESH_LM_PREFILL[0]} x {MESH_LM_PREFILL[1]} tokens at "
                  f"1x2: {r['launches']} launches per rank, {r['linears_equal']} linears "
                  f"torch.equal, logits {r['logit_err']:.3g}·max|logit| from single-process")
        for shape, r in per_rank[0].get("seq", {}).items():
            res[f"seq prefill {shape[0]}x{shape[1]}"] = r
            print(f"phase 14e: sequence-sharded prefill of 1 x {MESH_SEQ_TOKENS} tokens at "
                  f"{shape[0]}x{shape[1]} TP-only: {MESH_LM_PER_STEP} launches per rank per pass "
                  f"on {r['rows']} rows each, {r['linears_equal']} linears torch.equal to the "
                  f"single-process prefill kernel's rows, logits {r['logit_err']:.3g}·max|logit| "
                  f"from single-process; rank 0 {r['ms']:.1f} ms vs single-process "
                  f"{r['single_ms']:.1f} ms (one pass each, CUDA events; all {world} ranks on one "
                  f"card: says nothing of scaling); case {r['seconds']:.1f} s; {smi}")
        if "train" in per_rank[0]:
            tr = res["train"] = per_rank[0]["train"]
            dn = tr["dense"]
            print(f"phase 14c: gemma-2b cut to {MESH_TRAIN_DEPTH} layers, fp32 dense, one step "
                  f"against single-process: worst leaf {dn['2x1']['worst_leaf']:.3g} / "
                  f"{dn['1x2']['worst_leaf']:.3g} of its own update at 2x1 / 1x2 (gate "
                  f"{MESH_TRAIN_DENSE_TOL:g}), losses {dn['2x1']['losses']} / "
                  f"{dn['1x2']['losses']} vs {dn['ref_losses']}, {dn['seconds']:.1f} s; "
                  f"fake-quant single-process reference {tr['ref_s']:.1f} s")
            a, b = tr["2x1"], tr["1x2"]
            print(f"phase 14c: fp32 fake-quant against single-process: a Trainer's "
                  f"step(s) 1-{a['steps']} at 2x1, params {a['param_err_over_update']:.3g} of the "
                  f"update in L2 (worst leaf {a['worst_leaf']:.3g} of its own), steps and save "
                  f"{tr['save_s']:.1f} s; a Trainer at 1x2 resumed from the save with params and "
                  f"momenta torch.equal ({tr['restore_s']:.1f} s), after its step {b['steps']} "
                  f"params {b['param_err_over_update']:.3g} (worst leaf "
                  f"{b['worst_leaf']:.3g}), {b['seconds']:.1f} s; losses {b['losses']} vs "
                  f"{tr['ref_losses']}")
            cp = res["compressed"] = per_rank[0]["compressed"]
            for k in ("2x1", "1x2"):
                c = cp[k]
                print(f"phase 14f: gemma-2b cut to {MESH_TRAIN_DEPTH} layers, dense, gradient "
                      f"compression M={MESH_COMPRESS_M}, one step at {k} against single-process: "
                      f"alphas {c['worst']['alpha']:.3g} apart at worst (rtol "
                      f"{MESH_COMPRESS_TOL[0]:g}); gradient {c['worst']['input']:.3g} of its own "
                      f"L2 from single-process at the worst leaf; {c['flagged']} of "
                      f"{c['elements']} elements near a sign change ({c['by_alpha']} within "
                      f"{MESH_COMPRESS_NEAR:g}·alpha, the rest within the gradients' own "
                      f"difference), {c['flipped']} of them took the other sign "
                      f"({c['flipped_beyond_alpha']} outside {MESH_COMPRESS_NEAR:g}·alpha); "
                      f"elsewhere recon within {MESH_COMPRESS_TOL[0]:g}·sum(alpha), "
                      f"update {c['worst']['update']:.3g} and error {c['worst']['error']:.3g} of "
                      f"their own L2 at the worst leaf (gate {MESH_COMPRESS_TOL[1]:g}); loss "
                      f"{c['loss']} vs {cp['ref_loss']}; step {c['seconds']:.1f} s (single-process "
                      f"{cp['ref_s']:.1f} s)")
            print(f"phase 14f: {cp['seconds']:.1f} s")
            p = res["pipeline"] = per_rank[0]["pipeline"]
            print(f"phase 14d: GPipe, 2 stages of one gemma-2b layer, {MESH_PIPE_MICRO} "
                  f"microbatches of {MESH_PIPE_X}: {p['err']:.3g}·max|y| from reference_apply, "
                  f"{p['launches']} launches per rank")
        print(f"phase 14: world {world}: {time.time() - t1:.1f} s (rank 0's whole restore of the "
              f"packed checkpoint {per_rank[0]['restore_s']:.1f} s"
              + (f", 14c {per_rank[0]['train']['seconds']:.1f} s" if "train" in per_rank[0]
                 else "")
              + "".join(f", 14e {k[0]}x{k[1]} {v['seconds']:.1f} s"
                        for k, v in per_rank[0].get("seq", {}).items())
              + (f", 14f {per_rank[0]['compressed']['seconds']:.1f} s"
                 if "compressed" in per_rank[0] else "") + ")")
    tmp.cleanup()
    res["seconds"] = time.time() - t0 - res["counter"]["seconds"]
    print(f"phase 14: {res['seconds']:.1f} s without 15b (budget {MESH_LM_BUDGET_S} s); "
          f"launches {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# phase 15: the dry run
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (  # (module, its arguments): gemma-2b decode_32k on the 256-rank fake mesh
    ("dense", ["repro_torch.launch.dryrun", "--arch", "gemma_2b", "--shape", "decode_32k",
               "--mesh", "single", "--force"]),
    ("tponly_binM2", ["repro_torch.launch.hillclimb", "--cell", "D", "--iter",
                      "tponly_binM2"]))
DRYRUN_TIMEOUT_S = 150
DRYRUN_BUDGET_S = 60


def counter_on_card(cfg, params, inputs, single_ms: float, smi: str) -> dict:
    """15b: one decode group step of the packed gemma-2b at 8 slots under
    ``CostCounter``: its logits ``torch.equal`` to the same step without the
    counter, its counted ``binary_matmul`` calls equal to the launch
    counter's delta, and the counted kernel MACs and bytes equal to the sum
    of phase 7's per-call bound inputs at the recorded call shapes."""
    from repro_torch.launch import cost_analysis as ca

    t0 = time.time()
    want, _ = api.decode_step(cfg, params, dict(inputs, cache=cm.tree_map(
        torch.clone, inputs["cache"])))
    calls = []
    ops.reset_launch_counts()
    with recorded_matmuls(calls), ca.CostCounter() as counter:
        got, _ = api.decode_step(cfg, params, dict(inputs, cache=cm.tree_map(
            torch.clone, inputs["cache"])))
    torch.cuda.synchronize()
    launched = ops.launch_counts()["binary_matmul"]
    if not torch.equal(got, want):
        fail(f"phase 15b: the counted step's logits differ from the step without the counter "
             f"(max |d| {float((got - want).abs().max()):.3g})")
    macs = nbytes = 0
    for x, B, alpha, kw, y in calls:
        T, K, N = x.reshape(-1, kw["K"]).shape[0], kw["K"], B.shape[-1]
        macs += T * K * N
        nbytes += 4 * T * K + B.numel() + 4 * alpha.numel() + 4 * T * N
    b = counter.binary
    if not (b["calls"] == launched == len(calls) == MESH_LM_PER_STEP
            and b["macs"] == macs and b["bytes"] == nbytes):
        fail(f"phase 15b: counted {b} against {launched} launches, {len(calls)} calls, "
             f"{macs} MACs and {nbytes} bytes at phase 7's per-call bound (want "
             f"{MESH_LM_PER_STEP} calls)")
    flops, moved = counter.total_flops(), counter.bytes_accessed
    bound_ms = max(moved / ca.HBM_BW, ca.compute_seconds(counter.flops)) * 1e3
    out = {"calls": b["calls"], "launches": launched, "macs": b["macs"],
           "kernel_bytes": b["bytes"], "flops": flops, "flops_by_class": dict(counter.flops),
           "bytes": moved, "peak_live_bytes": counter.peak_live_bytes,
           "bound_ms": bound_ms, "step_ms": single_ms, "seconds": time.time() - t0}
    print(f"phase 15b: gemma-2b packed decode step at {MESH_LM_SLOTS} slots under CostCounter: "
          f"logits torch.equal to the step without it; {b['calls']} binary_matmul calls counted "
          f"= {launched} launches; kernel MACs {b['macs']} and bytes {b['bytes']} = phase 7's "
          f"per-call bound inputs; counted step {flops:.4g} FLOPs "
          f"({', '.join(f'{k} {v:.4g}' for k, v in sorted(counter.flops.items()))}), "
          f"{moved:.4g} bytes (unfused eager ops), peak {counter.peak_live_bytes / 1e9:.3f} GB "
          f"made during the step: {bound_ms:.3f} ms at the data-sheet rates beside the measured "
          f"step {single_ms:.3f} ms; {out['seconds']:.1f} s; {smi}")
    return out


def start_dryrun(out_dir: Path) -> dict:
    """15a's subprocesses (``python -m repro_torch.launch.dryrun`` and
    hillclimb cell D's ``tponly_binM2`` on a cuda-typed fake mesh), started
    while phase 14's ranks run: they count on the host.  name -> (process,
    its log file, its start time)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for name, args in DRYRUN_CELLS:
        log = open(out_dir / f"dryrun_{name}.log", "w+")
        procs[name] = (subprocess.Popen([sys.executable, "-m", *args, "--mesh-device", "cuda"],
                                        cwd=ROOT, env=env, stdout=log,
                                        stderr=subprocess.STDOUT, text=True),
                       log, time.time())
    return procs


def stop_dryrun(procs: dict) -> None:
    for proc, log, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def dryrun_phase(procs: dict, out_dir: Path, smi: str) -> dict:
    """15a: the production dry run of gemma-2b decode_32k on a cuda-typed
    fake mesh of 256 ranks, in the subprocesses of :func:`start_dryrun`,
    each given DRYRUN_TIMEOUT_S from its start (the caller stops them with
    :func:`stop_dryrun`): both records ok, the packed
    one counting MESH_LM_PER_STEP binary_matmul calls per device,
    model_flops = 2 · N_active · 128.  The phase's time is its wait."""
    t0 = time.time()
    logs = {}
    for name, (proc, log, start) in procs.items():
        try:
            proc.wait(timeout=max(1.0, start + DRYRUN_TIMEOUT_S - time.time()))
        except subprocess.TimeoutExpired:
            fail(f"phase 15a: {name} ran past {DRYRUN_TIMEOUT_S} s")
        log.seek(0)
        logs[name] = log.read()
        (out_dir / f"dryrun_{name}.log").unlink()
    (out_dir / "dryrun.log").write_text("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    cfg = get_config("gemma_2b")
    model_flops = 2 * api.count_params(cfg, active_only=True) * 128
    res = {"launches": {k: 0 for k in TPU_KERNELS}}
    for name, _ in DRYRUN_CELLS:
        if procs[name][0].returncode:
            fail(f"phase 15a: {name}: exit {procs[name][0].returncode} "
                 f"(chiprun_out/dryrun.log):\n{logs[name][-2000:]}")
        tag = "" if name == "dense" else f"__{name}"
        rec = json.loads((ROOT / "experiments" / "torch_dryrun" /
                          f"gemma_2b__decode_32k__single{tag}.json").read_text())
        calls = rec.get("binary_matmul", {}).get("calls")
        want_calls = 0 if name == "dense" else MESH_LM_PER_STEP
        if (rec["status"] != "ok" or rec["mesh_device"] != "cuda" or calls != want_calls
                or rec["model_flops"] != model_flops):
            fail(f"phase 15a: {name}: status {rec['status']} on {rec.get('mesh_device')}, "
                 f"{calls} binary_matmul calls per device (want {want_calls}), model_flops "
                 f"{rec.get('model_flops')} (want {model_flops}): {rec.get('error', '')}")
        res[name] = {k: rec[k] for k in (
            "flops_per_device", "flops_by_class", "bytes_per_device", "wire_bytes_per_device",
            "compute_s", "memory_s", "collective_s", "bound", "model_flops",
            "model_flops_ratio", "collective_ops", "memory_stats", "binary_matmul",
            "total_s")}
        print(f"phase 15a: gemma-2b decode_32k on the 16x16 fake mesh (cuda), {name}: compute "
              f"{rec['compute_s']:.6f} s, memory {rec['memory_s']:.6f} s, collective "
              f"{rec['collective_s']:.6f} s, bound {rec['bound']}, model_flops_ratio "
              f"{rec['model_flops_ratio']:.4f}; {calls} binary_matmul calls per device; "
              f"collectives {rec['collective_ops']}; counted in {rec['total_s']} s "
              f"(H100 SXM5 data-sheet rates, an eager step's count; {smi})")
    res["seconds"] = time.time() - t0
    return res


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    # phase 8c's bit-exact resume needs deterministic cuBLAS, whose workspace
    # is fixed by this variable before the first cuBLAS call
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.time()
    _build.build_all()
    print(f"build: {len(_build.KERNELS)} kernels in {time.time() - t0:.1f} s")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    quant = QuantConfig(mode="binary", M=2)
    nets = {
        "cnn_a": (cnn.init_cnn_a(gen, device=dev), (64, 48, 48, 3)),
        "mobilenet": (cnn.init_mobilenet(gen, width_mult=1.0, n_classes=1000, device=dev),
                      (16, 224, 224, 3)),
    }
    programs = {}
    for arch, (params, shape) in nets.items():
        t0 = time.time()
        programs[arch] = deploy.compile(params, arch, quant, shape, device=dev,
                                        golden=False)
        torch.cuda.synchronize()
        print(f"compile {arch} {shape}: {len(programs[arch])} instructions, plans "
              f"{[tuple(i.plan) for i in programs[arch].instrs]}, {time.time() - t0:.1f} s")

    max_err = check_kernels(programs, gen, dev)

    inputs = {arch: torch.randn(p.input_shape, generator=gen).to(dev)
              for arch, p in programs.items()}
    launches = {k: 0 for k in TPU_KERNELS}
    for phase, arch in ((2, "cnn_a"), (3, "mobilenet")):
        for k, v in run_main_path(phase, arch, programs[arch], inputs[arch]).items():
            launches[k] += v

    rows, totals = time_kernels(programs, gen, dev)
    forward = {}
    for arch, program in programs.items():
        x = inputs[arch]
        forward[arch] = {"batch": program.input_shape[0],
                         "execute_ms": loop_ms(lambda: deploy.execute(program, x)),
                         "execute_reference_ms": loop_ms(
                             lambda: deploy.execute_reference(program, x), reps=3)}
        print(f"phase 4: {arch} forward at batch {program.input_shape[0]}: execute "
              f"{forward[arch]['execute_ms']:.4f} ms, execute_reference "
              f"{forward[arch]['execute_reference_ms']:.4f} ms (host work included)")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    profiles = {arch: profile_forward(arch, program, inputs[arch], out_dir)
                for arch, program in programs.items()}

    serve = serve_phase(nets["mobilenet"][0], quant, gen, dev, out_dir)
    lm = lm_phase(gen, dev, out_dir)
    gc.collect()                      # phase 7's model is gone: its memory goes back
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = train_phase(dev, out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    verify = verify_phase(programs, inputs, dev, out_dir)
    fuzz_launches, soak_launches = verify["fuzz"]["launches"], verify["soak"]["launches"]
    gc.collect()                      # phase 9's servers are gone: their memory goes back
    torch.cuda.empty_cache()
    moe = moe_phase(gen, dev, out_dir)
    moe_launches = moe["launches"]
    gc.collect()                      # phase 10's models are gone: their memory goes back
    torch.cuda.empty_cache()
    ssm = ssm_phase(gen, dev, out_dir)
    ssm_launches = ssm["launches"]
    gc.collect()                      # phase 11's models are gone: their memory goes back
    torch.cuda.empty_cache()
    encdec = encdec_phase(gen, dev, out_dir)
    encdec_launches = encdec["launches"]
    gc.collect()                      # phase 12's models are gone: their memory goes back
    torch.cuda.empty_cache()
    mesh = mesh_phase(programs, dev, out_dir, smi)
    mesh_launches = mesh["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    dry_procs = {}
    try:
        mesh_lm = mesh_lm_phase(dev, out_dir, smi,
                                lambda: dry_procs.update(start_dryrun(out_dir)))
        dryrun = dryrun_phase(dry_procs, out_dir, smi)
    finally:
        stop_dryrun(dry_procs)
    mesh_lm_launches = mesh_lm["launches"]
    dryrun["counter"] = mesh_lm.pop("counter")
    dryrun["launches"]["binary_matmul"] = dryrun["counter"]["launches"]
    dryrun["seconds"] += dryrun["counter"]["seconds"]
    dryrun_launches = dryrun["launches"]
    print(f"phase 15: {dryrun['seconds']:.1f} s (budget {DRYRUN_BUDGET_S} s; 15a's wait after "
          f"phase 14, whose ranks its subprocesses ran beside; 15b ran on phase 14b's model); "
          f"launches {dryrun_launches}")

    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        tot = totals[name]
        t_bytes = tot["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = tot["flops"] / FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (launches[name] + lm["serve"]["launches"][name]
                         + lm["bf16_launches"][name]
                         + train["cnn_a"]["launches"][name] + fuzz_launches[name]
                         + soak_launches[name] + moe_launches[name] + ssm_launches[name]
                         + encdec_launches[name] + mesh_launches[name]
                         + mesh_lm_launches[name] + dryrun_launches[name]),
            "max_abs_err": max([max_err[name]] + (
                [lm["max_abs_err"]] + [moe[a]["max_abs_err"] for a in MOE_ARCHS]
                + [ssm[a]["max_abs_err"] for a in SSM_ARCHS]
                + [encdec[a]["max_abs_err"] for a in ENCDEC_ARCHS] if name == "binary_matmul"
                else [])),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tot["library_ms"], "instr_ms": tot["instr_ms"],
            "cnn_launches": launches[name], "serve_launches": serve["launches"][name],
            "lm_launches": lm["serve"]["launches"][name],
            "lm_bf16_launches": lm["bf16_launches"][name],
            "train_launches": train["cnn_a"]["launches"][name],
            "fuzz_launches": fuzz_launches[name], "soak_launches": soak_launches[name],
            "moe_launches": moe_launches[name], "ssm_launches": ssm_launches[name],
            "encdec_launches": encdec_launches[name], "mesh_launches": mesh_launches[name],
            "mesh_lm_launches": mesh_lm_launches[name],
            "dryrun_launches": dryrun_launches[name]})
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": kind, "nvidia_smi": smi, "torch": torch.__version__,
         "kernels": kernels, "layers": rows, "forward": forward, "profiles": profiles,
         "serve": serve, "lm": lm, "train": train, "verify": verify, "moe": moe, "ssm": ssm,
         "encdec": encdec, "mesh": mesh, "mesh_lm": mesh_lm, "dryrun": dryrun},
        indent=1))
    print("timings: ms, plain_ms, library_ms and bound_ms sum one forward of CNN-A "
          "(batch 64) and one of MobileNetV1-224 (batch 16); launches counts phases 2 "
          "and 3 (three calls of each network), phase 7's serving of gemma-2b (fp32) and "
          "of the dense LMs in bf16 (7b-7d), phase "
          "8a's execute of the retrained CNN-A, phase 9a's fuzz, phase 9c's soaks, phase "
          "10's serving of DeepSeek-V3 and grok-1, phase 11's of mamba2-2.7b and zamba2-7b, "
          "phase 12's of whisper-medium and internvl2-2b, phases 13 and 14's ranks and phase "
          "15b's counted step; the LM shapes' times are under \"lm\", \"moe\", \"ssm\" and "
          "\"encdec\", phase 13's under \"mesh\", phase 14's under \"mesh_lm\" and phase 15's "
          "under \"dryrun\" in chiprun_out/chip_smoke.json")
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
