"""Perf hillclimb driver (counterpart of ``repro/launch/hillclimb.py``).

The JAX package's cells and iterations, counted by the port's dry run
(``launch/dryrun.py``):
  A qwen3_14b/decode_32k   — binary weights against decode's memory wall;
  B grok_1_314b/train_4k   — FSDP expert gathers, remat and capacity;
  C codeqwen15_7b/train_4k — attention's S^2 traffic in training;
  D gemma_2b/decode_32k    — the serving layout (TP-only, binary, seq-shard).

Each iteration is (tag, cfg overrides); its record lands in
experiments/torch_dryrun/<arch>__<shape>__<mesh>__<tag>.json next to the
baselines.  The JAX records of binary iterations also carry
``dequant_artifact_bytes`` / ``adjusted_*``: XLA's CPU lowering of the
reference binary path materializes fp32 W_hat, which the JAX driver
subtracts.  The port counts a packed linear by the kernel's own bytes
(``binary_matmul``'s meta route, ``cost_analysis.binary_matmul_work``), so
there is no artifact to subtract and those fields are not written;
``report.perf_table`` then reads ``memory_s``.

Usage:
    python -m repro_torch.launch.hillclimb --cell A          # all iterations
    python -m repro_torch.launch.hillclimb --cell D --iter tponly_binM2
"""
from __future__ import annotations

import argparse

from repro_torch.core.binlinear import QuantConfig
from repro_torch.launch import dryrun


def _bin(M, m_active=None):
    return QuantConfig(mode="binary", M=M, K_iters=2, m_active=m_active)


CELLS = {
    # cell: (arch, shape, mesh, [(tag, overrides), ...])
    "A": ("qwen3_14b", "decode_32k", "single", [
        ("bin_M4", {"quant": _bin(4)}),
        ("bin_M4_tponly", {"quant": _bin(4), "serve_fsdp": False}),
        ("bin_M4_m2_tponly", {"quant": _bin(4, m_active=2), "serve_fsdp": False}),
        ("dense_tponly", {"serve_fsdp": False}),
        ("dense_seqshard", {"serve_fsdp": False, "kv_seq_shard": True}),
        ("bin_M4_seqshard", {"quant": _bin(4), "serve_fsdp": False, "kv_seq_shard": True}),
    ]),
    "B": ("grok_1_314b", "train_4k", "single", [
        ("remat_off", {"remat": False}),
        ("cf10_remat_off", {"remat": False, "capacity_factor": 1.0}),
    ]),
    "C": ("codeqwen15_7b", "train_4k", "single", [
        ("chunk512", {"attn_chunk": 512}),
        ("chunk512_onehot", {"attn_chunk": 512, "onehot_loss": True}),
        ("chunk1024_onehot", {"attn_chunk": 1024, "onehot_loss": True}),
        ("mixedprec_chunk_onehot", {"attn_chunk": 1024, "onehot_loss": True}),
    ]),
    "D": ("gemma_2b", "decode_32k", "single", [
        ("tponly", {"serve_fsdp": False}),
        ("tponly_binM2", {"quant": _bin(2), "serve_fsdp": False}),
        ("seqshard_binM2", {"quant": _bin(2), "serve_fsdp": False, "kv_seq_shard": True}),
    ]),
}


def run_iteration(cell: str, tag: str, overrides: dict, *, mesh_device: str = "cuda"):
    arch, shape, mesh_kind, _ = CELLS[cell]
    return dryrun.run_and_save(arch, shape, mesh_kind, tag=tag, overrides=overrides,
                               mesh_device=mesh_device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(CELLS))
    ap.add_argument("--iter", default=None)
    ap.add_argument("--mesh-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    _, _, _, iters = CELLS[args.cell]
    failures = 0
    for tag, overrides in iters:
        if args.iter and tag != args.iter:
            continue
        rec = run_iteration(args.cell, tag, overrides, mesh_device=args.mesh_device)
        failures += rec["status"] == "error"
        keys = ("status", "compute_s", "memory_s", "collective_s", "bound")
        print(f"[{args.cell}:{tag}]", {k: rec.get(k) for k in keys if rec.get(k) is not None})
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
