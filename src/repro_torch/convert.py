"""Carry weights from the JAX package into the port by way of numpy.

``params_from_numpy`` takes a params tree whose array leaves were converted
with ``np.asarray`` — fp ``{w, b}`` trees, or packed trees with
``B_packed`` / ``B_tap_packed`` / ``alpha`` / ``b``, or an LM tree with
stacked ``[L, ...]`` leaves — and returns the same tree of torch tensors on
``device``.  bfloat16 leaves (numpy's ``ml_dtypes`` type, which torch does
not read) cross bit for bit.  The port's ``compile`` then builds the
same program from the same bytes.  Only numpy is read, so the port never
needs jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``.  0-d arrays (static ints such as a conv's ``kh``) become
    Python scalars; other leaves are kept as they are."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(u) for k, u in v.items()}
        if isinstance(v, np.ndarray):
            if v.ndim == 0:
                return v.item()
            if v.dtype.name == "bfloat16":
                return torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
            return torch.from_numpy(np.array(v, copy=True)).to(dev)
        return v

    return conv(tree)
