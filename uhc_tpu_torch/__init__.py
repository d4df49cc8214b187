"""PyTorch/CUDA port of uhc_tpu (closed-loop copycat evaluation slice).

The JAX package `uhc_tpu` stays the reference; this package mirrors its
subpackages and module names and imports only torch, numpy, scipy and the
standard library. Physics runs in full float32: TF32 is switched off for
matrix products and convolutions when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from uhc_tpu_torch.device import resolve_device  # noqa: E402,F401
