"""The benchmark of dfd_tpu_torch (see run.py)."""
