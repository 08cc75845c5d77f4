"""CUDA kernels, their launchers, plain PyTorch versions and wrappers (port of ``repro.kernels``)."""
