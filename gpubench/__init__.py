"""The benchmark of ``mjrl_tpu_torch`` on an NVIDIA GPU: ``python gpubench/run.py``."""
