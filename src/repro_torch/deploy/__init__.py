"""Compile-once deployment API (paper §IV: compiler + instruction stream).

    from repro_torch import deploy

    program = deploy.compile(params, "cnn_a", quant, input_shape=(64, 48, 48, 3))
    logits = deploy.execute(program, x)                  # all packed levels
    logits = deploy.execute(program, x, m_active=1)      # §IV-D global switch
    logits = deploy.execute(program, x, m_active=[1, 2, 2, 2, 2])  # per layer
"""
from repro_torch.deploy.compiler import compile
from repro_torch.deploy.executor import execute, execute_reference
from repro_torch.deploy.program import (BinArrayProgram, ConvInstr, DWConvInstr,
                                        LayerStats, LinearInstr, TilePlan)

__all__ = [
    "BinArrayProgram", "ConvInstr", "DWConvInstr", "LayerStats", "LinearInstr",
    "TilePlan", "compile", "execute", "execute_reference",
]
