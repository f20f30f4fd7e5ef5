"""The benchmark of ``gwen_tpu_torch`` on one NVIDIA H100: ``python3 -m
portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

Nothing here imports ``jax`` or ``gwen_tpu``; ``port.py`` alone imports
the program, and ``reference/`` nothing of it.
"""
