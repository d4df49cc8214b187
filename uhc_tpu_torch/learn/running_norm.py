"""Running observation normalization (ZFilter twin of
uhc_tpu.learn.running_norm): evaluation only reads the statistics."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class RunningStats:
    n: torch.Tensor      # () count
    mean: torch.Tensor   # (D,)
    m2: torch.Tensor     # (D,) sum of squared deviations


def init(dim: int, device="cuda") -> RunningStats:
    z = torch.zeros(dim, device=device)
    return RunningStats(torch.zeros((), device=device), z, z.clone())


def from_numpy(d, device="cuda") -> RunningStats:
    """A checkpoint's running_stats dict {n, mean, m2} -> tensors."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return RunningStats(t(d["n"]), t(d["mean"]), t(d["m2"]))


def std(rs: RunningStats) -> torch.Tensor:
    var = torch.where(rs.n > 1, rs.m2 / torch.clamp(rs.n - 1, min=1.0),
                      rs.mean ** 2)
    return torch.sqrt(torch.clamp(var, min=0.0))


def normalize(rs: RunningStats, x: torch.Tensor,
              clip: float = 5.0) -> torch.Tensor:
    """(x - mean)/(std + 1e-8), clipped."""
    return torch.clamp((x - rs.mean) / (std(rs) + 1e-8), -clip, clip)
