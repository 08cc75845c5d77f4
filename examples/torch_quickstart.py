"""Quickstart in the PyTorch/CUDA port: the paper's technique in five steps.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of ``examples/quickstart.py``:

1. binarize a weight matrix with Algorithm 1 and the improved Algorithm 2;
2. compare their residuals (the paper's central §II claim);
3. run the binary dot product through ``binary_matmul``: on the card its
   CUDA kernel, held against its plain PyTorch version (``kernels/ref.py``);
4. compile CNN-A into a BinArrayProgram (paper §IV: one macro-instruction
   per layer, tile plans frozen offline) and execute it;
5. flip the runtime accuracy<->throughput switch (m_active, §IV-D), global
   and per layer, on the same compiled program.

Runs on the card unless ``--device cpu`` is given (then every kernel runs
its plain version), and fails without one.
"""
import argparse

import torch

from repro_torch import deploy, resolve_device
from repro_torch.core import binarize as bz
from repro_torch.core import binlinear as bl
from repro_torch.core.binlinear import QuantConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import cnn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)

    # -- 1+2: Algorithm 1 vs Algorithm 2 ------------------------------------
    W = torch.randn((256, 64), generator=gen)
    for M in (1, 2, 3, 4):
        e1 = float(bz.residual_error(W, bz.algorithm1(W, M=M)))
        e2 = float(bz.residual_error(W, bz.algorithm2(W, M=M, K_iters=50)))
        cf = bz.compression_factor(256, M)
        print(f"M={M}: ||W-What||^2  Alg1={e1:8.2f}  Alg2={e2:8.2f} "
              f"(improvement {100 * (e1 - e2) / e1:5.1f}%)  cf={cf:.1f}x")

    # -- 3: the kernel vs its plain version ----------------------------------
    x = torch.randn((8, 256), generator=gen)
    packed = bl.binarize_params({"w": W}, QuantConfig(mode="binary", M=2, K_iters=20))
    kops.reset_launch_counts()
    y_kernel = kops.binary_matmul(x.to(dev), packed["B_packed"].to(dev),
                                  packed["alpha"].to(dev), K=256, group_size=256)
    launches = kops.launch_counts()["binary_matmul"]
    y_plain = kref.binary_matmul_ref(x, packed["B_packed"], packed["alpha"], K=256,
                                     group_size=256)
    what = "CUDA kernel" if dev.type == "cuda" else "plain version"
    print(f"\nbinary_matmul on {dev} ({what}, {launches} launch) vs plain version "
          f"max |err|: {float((y_kernel.cpu() - y_plain).abs().max()):.2e}")
    print(f"binary vs dense matmul MSE (M=2): {float(((y_plain - x @ W) ** 2).mean()):.4f}")

    # -- 4: compile once, execute many (paper §IV) ---------------------------
    params = cnn.init_cnn_a(torch.Generator().manual_seed(0), device=dev)
    qc = QuantConfig(mode="binary", M=2, K_iters=8)
    program = deploy.compile(params, "cnn_a", qc, input_shape=(4, 48, 48, 3), device=dev)
    print("\ncompiled CNN-A instruction stream (frozen tile plans):")
    for s in program.layer_stats():
        plan = " ".join(f"{k}={v}" for k, v in s["plan"].items())
        print(f"  {s['name']:<5} {s['kind']:<6} {plan:<22} macs={s['macs']:>9,} "
              f"weight_KB={s['weight_bytes'] / 1024:>7.1f}")
    print(f"  total: {program.totals()['macs']:,} MACs, "
          f"{program.totals()['weight_bytes']:,} packed weight bytes")

    xb = torch.randn((4, 48, 48, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        dense_logits = cnn.cnn_a_forward(params, xb)       # fp baseline
    full = deploy.execute(program, xb)

    # -- 5: runtime accuracy<->throughput switch on the compiled program -----
    def mse(a):
        return float(((a - dense_logits) ** 2).mean())

    print("\nruntime m_active switch (same program, no recompilation):")
    for m in (1, 2):
        lg = deploy.execute(program, xb, m_active=m)
        print(f"  m_active={m} (global):     logits MSE vs dense = {mse(lg):.5f} "
              f"({'high-throughput' if m < 2 else 'high-accuracy'} mode)")
    sched = [1, 2, 2, 2, 2]   # cheap first conv, full levels elsewhere
    lg = deploy.execute(program, xb, m_active=sched)
    print(f"  schedule {sched}: logits MSE vs dense = {mse(lg):.5f} (per-layer §IV-D)")
    print(f"  full-level program vs dense MSE = {mse(full):.5f}")


if __name__ == "__main__":
    main()
