"""Compile-once deployment API (paper §IV: compiler + instruction stream).

    from repro_torch import deploy

    program = deploy.compile(params, "cnn_a", quant, input_shape=(64, 48, 48, 3))
    logits = deploy.execute(program, x)                  # all packed levels
    logits = deploy.execute(program, x, m_active=1)      # §IV-D global switch
    logits = deploy.execute(program, x, m_active=[1, 2, 2, 2, 2])  # per layer
    deploy.self_test(program)                            # golden replay
"""
from repro_torch.deploy.compiler import (ProgramIntegrityError, abstract_program,
                                         compile, load_latest_good, load_program,
                                         save_program)
from repro_torch.deploy.executor import execute, execute_reference
from repro_torch.deploy.program import (BinArrayProgram, ConvInstr, DWConvInstr,
                                        GoldenRecord, LayerStats, LinearInstr,
                                        TilePlan)
from repro_torch.deploy.selftest import (SelfTestFailure, compute_golden,
                                         golden_rungs, self_test)

__all__ = [
    "BinArrayProgram", "ConvInstr", "DWConvInstr", "GoldenRecord", "LayerStats",
    "LinearInstr", "ProgramIntegrityError", "SelfTestFailure", "TilePlan",
    "abstract_program", "compile", "compute_golden", "execute", "execute_reference",
    "golden_rungs", "load_latest_good", "load_program", "save_program", "self_test",
]
