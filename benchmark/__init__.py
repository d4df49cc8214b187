"""The benchmark of the PyTorch / CUDA port `uhc_tpu_torch` (see run.py)."""
