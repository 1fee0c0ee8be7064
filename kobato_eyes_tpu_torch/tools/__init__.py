"""The port's measuring entry points, one module each, run as
``python -m kobato_eyes_tpu_torch.tools.<name>``: counterparts of the
repository's ``tools/bench_*.py``, ``tools/mfu_probe.py`` and
``tools/trace_ops.py``, with their flags, data and JSON keys, plus
``--device``."""
