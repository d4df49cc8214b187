"""Fixed-length window datasets (PyTorch twin of uhc_tpu.data.windows).

Windows are integer arithmetic over the stacked expert library:
`WindowSampler` draws (seq_idx, start) pairs from a numpy RandomState, the
same draws as the JAX package's for the same seed, and `gather_windows`
pulls (B, W, ...) batches from the library's device tensors in one indexed
read per key.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class WindowSampler:
    """Uniformly samples fixed-length windows over a motion library: a
    random sequence at least `window` frames long, a random start with
    the window fully inside it."""

    def __init__(self, lengths: Sequence[int], window: int, seed: int = 0):
        self.lengths = np.asarray(lengths, np.int64)
        self.window = int(window)
        self.valid = np.where(self.lengths >= self.window)[0]
        if len(self.valid) == 0:
            raise ValueError(
                f"no sequence is >= window={window} frames long")
        self.rng = np.random.RandomState(seed)

    def sample(self, batch: int):
        """-> (seq_idx (B,), start (B,)) numpy int arrays."""
        sidx = self.valid[self.rng.randint(0, len(self.valid), batch)]
        hi = np.maximum(self.lengths[sidx] - self.window, 1)
        start = (self.rng.rand(batch) * hi).astype(np.int64)
        return sidx, start

    def iter_all(self, stride: Optional[int] = None):
        """Deterministic sweep of all windows; stride defaults to the
        window length."""
        stride = stride or self.window
        for s in self.valid:
            for st in range(0, int(self.lengths[s]) - self.window + 1,
                            stride):
                yield int(s), st


def gather_windows(lib: Dict[str, torch.Tensor], keys: List[str],
                   seq_idx, start, window: int) -> Dict[str, torch.Tensor]:
    """Gather (B, window, ...) batches from stacked (S, T, ...) library
    tensors, on the library's device."""
    dev = lib[keys[0]].device
    seq_idx = torch.as_tensor(np.asarray(seq_idx), dtype=torch.long,
                              device=dev)
    start = torch.as_tensor(np.asarray(start), dtype=torch.long, device=dev)
    t = start[:, None] + torch.arange(window, device=dev)[None, :]
    return {k: lib[k][seq_idx[:, None], t] for k in keys}
