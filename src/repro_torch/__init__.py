"""BinArray in PyTorch: the compile-once deployment path on an NVIDIA card.

A port of the JAX package ``repro`` (which stays the reference).  Layout is
NHWC at every public function and inside the kernels, as in the JAX package.
The port imports ``torch`` and never ``jax`` or anything of ``repro``.

    from repro_torch import deploy
    from repro_torch.models import cnn

    params = cnn.init_cnn_a(torch.Generator().manual_seed(0))      # on "cuda"
    program = deploy.compile(params, "cnn_a", QuantConfig(mode="binary"),
                             input_shape=(64, 48, 48, 3))
    logits = deploy.execute(program, x)                  # CUDA kernels

Entry points (``compile``, ``init_*``, ``params_from_numpy``) default to
``device="cuda"`` and raise when there is no card; pass ``device="cpu"`` to
run the plain PyTorch versions of the kernels instead.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is no card (the port never carries on on the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev
