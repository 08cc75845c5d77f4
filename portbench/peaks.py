"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W).

The kernels sum in fp32 FFMA outside the tensor cores, so their peak is
the fp32 rate; no cell selects a tensor-core route.  A card set below
700 W runs slower under load: every run prints its power limit beside
these numbers.
"""
FP32_FLOPS = 67e12          # FLOP/s, fp32, not tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3
