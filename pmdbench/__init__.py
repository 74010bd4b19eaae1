"""Benchmark of ``localmd_tpu_torch`` on one NVIDIA GPU (see ``run.py``)."""
