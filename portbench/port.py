"""The system under test: the only module of the benchmark that imports
``repro_torch``.

It packs the benchmark's levels with the port's own packing functions,
compiles them with ``repro_torch.deploy.compile`` (no Algorithm 2 runs:
the tree is already packed), and hands out the port's executor and
``CNNService``.  The benchmark reads nothing else of the port.
"""
from __future__ import annotations

from pathlib import Path

import repro_torch
import torch
from repro_torch import deploy
from repro_torch.core import binarize as bz
from repro_torch.core.binlinear import QuantConfig
from repro_torch.deploy import executor
from repro_torch.kernels import _build
from repro_torch.kernels.binary_conv import pack_taps
from repro_torch.kernels.binary_dwconv import pack_dw_taps
from repro_torch.serve_cnn import CNNService, SLOConfig

from portbench.network import Layer

ORIGIN = Path(repro_torch.__file__).resolve().parent   # the package under test


def load_kernels() -> None:
    """Build (first run in a checkout only) and load the port's three
    kernel libraries, which ``repro_torch.kernels._build`` keeps under
    ``src/repro_torch/csrc/_build/`` inside the checkout."""
    for name in _build.build_all():
        _build.load(name)


def pack(layer: Layer, w: dict) -> dict:
    """One layer of the packed tree ``deploy.compile`` takes, from the
    benchmark's ±1 levels, alphas and bias (``weights.py`` layouts)."""
    B, alpha = w["B"], w["alpha"]
    M = B.shape[0]
    if layer.kind == "conv":
        _, kh, kw, C, D = B.shape
        return {"B_tap_packed": pack_taps(B.reshape(M, kh * kw * C, D), kh, kw, C),
                "alpha": alpha.reshape(M, 1, D), "b": w["bias"]}
    if layer.kind == "dwconv":
        _, kh, kw, C = B.shape
        return {"B_tap_packed": pack_dw_taps(B.reshape(M, kh * kw, C)),
                "alpha": alpha, "b": w["bias"]}
    return {"B_packed": bz.pack_bits(bz.pad_rows_to_byte(B)),
            "alpha": alpha.reshape(M, 1, -1), "b": w["bias"]}


def compile_program(config: dict, net: list[Layer], weights: dict, batch: int,
                    device, *, golden: bool = False):
    """``deploy.compile`` of the packed tree at ``batch`` images, so its tile
    plans are frozen for the cell's own shape."""
    tree = {layer.name: pack(layer, weights[layer.name]) for layer in net}
    quant = QuantConfig(mode="binary", M=config["levels"])
    return deploy.compile(tree, config["port_arch"], quant,
                          (batch,) + tuple(config["input_hwc"]), device=device,
                          golden=golden)


def execute(program, x: torch.Tensor, m_active) -> torch.Tensor:
    """The port's executor, looked up at each call (as ``CNNService``'s
    default path does), so a test can plant a fault underneath."""
    return executor.execute(program, x, m_active)


def service(program, svc: dict, execute_fn=None) -> CNNService:
    """A ``CNNService`` as a traffic file's ``service`` block states it."""
    return CNNService(program, batch_size=svc["batch_size"], max_queue=svc["max_queue"],
                      slo=SLOConfig(target_ms=svc.get("slo_target_ms")),
                      selftest_every=svc.get("selftest_every"), execute_fn=execute_fn)
