"""The rules a program must meet to run on the port's CUDA kernels — as data.

Takes the place of ``repro/analysis/mosaic_rules.py`` (the TPU's block
tiling rules).  Each rule mirrors a check the port's launchers
(``kernels/binary_{conv,dwconv,matmul}.py launch``) or plan pickers
(``kernels/ops.py``) already make, so ``verify.py`` can refuse a program
before its first launch instead of at it.  ERROR: a launcher would refuse
the program, or run another schedule than the one frozen in it; WARN:
legal but not what ``compile`` would have made.

``MESH_RULES`` are ``verify_mesh_plan``'s, on a ``distributed.MeshPlan``:
the JAX package's ``shard-*`` ids, with ``shard-tile`` in place of Mosaic's
``shard-lane``.

``TRACE_RULES`` are the rules ``trace_lint.py`` checks on what one
``execute`` call runs, with the JAX package's ids; ``verify_program``
never raises them.
"""
from __future__ import annotations

import dataclasses

ERROR = "ERROR"
WARN = "WARN"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One checkable rule with a stable id and its default severity."""

    id: str
    severity: str
    summary: str


RULES: dict[str, Rule] = {r.id: r for r in [
    # --- the instruction chain ---------------------------------------------
    Rule("shape-chain", ERROR,
         "each instruction's input (after its pre-op) must match the "
         "previous instruction's output"),
    Rule("epilogue-pre", ERROR, "pre-op must be one of none | flatten | gap"),
    Rule("conv-padding", ERROR, "conv padding must be SAME or VALID"),
    Rule("epilogue-pool", ERROR,
         "conv output must be non-empty and divisible by the pool window "
         "(downsampling-only pooling, paper §III-B)"),
    # --- packed buffers ----------------------------------------------------
    Rule("pack-width", ERROR,
         "packed weights must be exactly ceil(K/8) / ceil(C/8) bytes wide, "
         "with one tap per filter position"),
    Rule("alpha-shape", ERROR,
         "alpha/bias must match the packed layout: [M, G, D] with "
         "G*group_size == K (conv/linear) or [M, C] (dw); bias [D]"),
    Rule("levels-mismatch", ERROR,
         "packed buffers and the instruction must agree on the level count M"),
    Rule("levels-max", ERROR,
         "the conv and matmul kernels fold at most 4 levels (MAX_LEVELS)"),
    Rule("tensor-layout", ERROR,
         "weights must be contiguous uint8 / float32 tensors on the program's "
         "device; a conv's packed bytes start on a 4-byte boundary"),
    # --- kernels and plans -------------------------------------------------
    Rule("dw-geometry", ERROR,
         "the depth-wise kernel takes 3x3 filters at stride 1 or 2 only"),
    Rule("plan-range", ERROR,
         "the frozen plan must lie in its kernel's plan space (conv: rows "
         "64/96/128 x cols 32/64/128; dw: 1/2/4/8 outputs per thread x "
         "32..256 channels; matmul: 1/2/4/8 rows x 32/64 columns)"),
    Rule("pool-rows", ERROR,
         "a conv block holds whole pool windows: pool^2 <= plan rows"),
    Rule("shared-memory", ERROR,
         "a conv launch's dynamic shared memory must fit one H100 block "
         "(232,448 bytes): the frozen plan's (binary_conv.shared_bytes), or "
         "where C < 8 the direct path's halo tile and folded weights "
         "(binary_conv.direct_plan, direct_shared_bytes)"),
    Rule("plan-noncanonical", WARN,
         "the plan differs from the pick compile makes for this layer "
         "(hand-built or stale)"),
    # --- stats -------------------------------------------------------------
    Rule("stats-drift", WARN,
         "LayerStats disagree with the values re-derived from the program "
         "(out_shape, padded_in, macs, weight_bytes)"),
]}


MESH_RULES: dict[str, Rule] = {r.id: r for r in [
    Rule("shard-divisibility", ERROR,
         "a bd-sharded layer's output channels must divide evenly over the "
         "model axis (and the recorded d_local must be that quotient)"),
    Rule("shard-tile", ERROR,
         "a bd shard's device-local plan must lie in the conv plan space, "
         "hold whole pool windows and fit one H100 block's shared memory "
         "(binary_conv.check_plan); takes the place of Mosaic's shard-lane"),
    Rule("shard-plan", ERROR,
         "MeshPlan structure must match the program: axes >= 1, one "
         "LayerShard per instruction, bd only on ConvInstr, with a frozen "
         "device-local plan"),
    Rule("shard-accounting", WARN,
         "LayerShard per-device weight bytes disagree with the stats' split "
         "(replicated copy vs weight_bytes / n_model)"),
    Rule("shard-batch", WARN,
         "global batch not divisible by the data axis: the last rank "
         "carries zero images every forward"),
]}


TRACE_RULES: dict[str, Rule] = {r.id: r for r in [
    Rule("trace-fp-conv", ERROR,
         "a full-binary call ran a library conv or product op (aten "
         "convolution / conv2d / _convolution / mm / addmm / bmm)"),
    Rule("trace-plan-pick", ERROR,
         "tile-plan picks ran inside the call (scheduling leaked past "
         "compile time)"),
    Rule("trace-f64", ERROR, "float64 values in the call (accidental promotion)"),
    Rule("trace-retrace", ERROR,
         "repeated identical calls picked plans, loaded kernel libraries or "
         "launched other than one kernel per instruction"),
]}
