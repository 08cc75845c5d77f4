"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
as the last line of standard output.  Nothing here imports ``jax`` or the
JAX package; only ``port.py`` imports ``repro_torch``.
"""
