"""Benchmark of ``kobato_eyes_tpu_torch`` on one NVIDIA card.

``python3 -m ketbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. Everything a
cell needs is found by name: its configuration in ``configs/<config>.json``,
its traffic mix in ``traffic/<mix>.json`` (whose ``driver`` names the
general generator in ``drivers/``), each per-layer metric's reader in
``metrics/<metric>.py`` and each plain reference in ``reference/``.

Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the port.
"""
