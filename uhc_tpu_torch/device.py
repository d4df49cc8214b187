"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Nothing falls
back to the CPU on its own: asking for CUDA where there is none raises.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda"; a CUDA device without a usable card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20, check=True).stdout.strip().splitlines()[0]
