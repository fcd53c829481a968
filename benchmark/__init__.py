"""The benchmark of ``dasac_tpu_torch`` on NVIDIA GPUs (``run.py``)."""
