"""Running observation normalization (ZFilter twin of
uhc_tpu.learn.running_norm): Welford statistics, merged batch by batch
during rollouts (Chan et al.'s parallel update) and read by evaluation."""
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


def stack(stats) -> RunningStats:
    """Per-sequence statistics: a list of S RunningStats -> one whose row
    s normalizes row s of an (S, D) batch (n as (S, 1), mean and m2 as
    (S, D))."""
    return RunningStats(torch.stack([r.n.reshape(1) for r in stats]),
                        torch.stack([r.mean for r in stats]),
                        torch.stack([r.m2 for r in stats]))


def update_batch(rs: RunningStats, x: torch.Tensor,
                 mask=None) -> RunningStats:
    """Merge a (B, D) batch (optionally row-masked) into the stats."""
    if mask is None:
        bn = x.new_tensor(float(x.shape[0]))
        bmean = x.mean(0)
        bm2 = ((x - bmean) ** 2).sum(0)
    else:
        m = mask.to(x.dtype)[:, None]
        bn = torch.clamp(m.sum(), min=1e-8)
        bmean = (x * m).sum(0) / bn
        bm2 = (((x - bmean) ** 2) * m).sum(0)
    n = rs.n + bn
    delta = bmean - rs.mean
    mean = rs.mean + delta * bn / n
    m2 = rs.m2 + bm2 + delta ** 2 * rs.n * bn / n
    return RunningStats(n, mean, m2)


def to_numpy(rs: RunningStats) -> dict:
    """The checkpoint layout {n, mean, m2} of numpy float32 arrays."""
    return {k: getattr(rs, k).detach().cpu().numpy()
            for k in ("n", "mean", "m2")}


def std(rs: RunningStats) -> torch.Tensor:
    var = torch.where(rs.n > 1, rs.m2 / torch.clamp(rs.n - 1, min=1.0),
                      rs.mean ** 2)
    return torch.sqrt(torch.clamp(var, min=0.0))


def normalize(rs: RunningStats, x: torch.Tensor,
              clip: float = 5.0) -> torch.Tensor:
    """(x - mean)/(std + 1e-8), clipped."""
    return torch.clamp((x - rs.mean) / (std(rs) + 1e-8), -clip, clip)
