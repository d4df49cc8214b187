"""Running observation normalization (ZFilter twin of
uhc_tpu.learn.running_norm): Welford statistics, merged batch by batch
during rollouts (Chan et al.'s parallel update) and read by evaluation."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uhc_tpu_torch.utils.spans import count


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


def update_batch(rs: RunningStats, x: torch.Tensor, mask=None,
                 dist=None) -> RunningStats:
    """Merge a (B, D) batch (optionally row-masked) into the stats. Under
    `dist` (learn/data_parallel.Dist) the batch is the global one: every
    rank's (count, mean, m2) is gathered and merged in rank order, so every
    rank holds the same statistics."""
    bn, bmean, bm2 = _moments(x, mask)
    if dist is not None:
        bn, bmean, bm2 = _merge_ranks(dist.gather(
            torch.cat([bn.reshape(1), bmean, bm2])))
    if mask is not None:
        bn = torch.clamp(bn, min=1e-8)
    n = rs.n + bn
    delta = bmean - rs.mean
    mean = rs.mean + delta * bn / n
    m2 = rs.m2 + bm2 + delta ** 2 * rs.n * bn / n
    return RunningStats(n, mean, m2)


def _moments(x: torch.Tensor, mask=None):
    """(count, mean, m2) of the rows of `x`, or of those `mask` keeps (the
    count unclamped: it may be 0)."""
    if mask is None:
        bmean = x.mean(0)
        # a tensor copied from the host: on a card the copy waits for the
        # stream (utils/spans.py counts it)
        count("host_sync")
        return (x.new_tensor(float(x.shape[0])), bmean,
                ((x - bmean) ** 2).sum(0))
    m = mask.to(x.dtype)[:, None]
    bn = m.sum()
    bmean = (x * m).sum(0) / torch.clamp(bn, min=1e-8)
    return bn, bmean, (((x - bmean) ** 2) * m).sum(0)


def _merge_ranks(parts: torch.Tensor):
    """Chan et al.'s merge of the (W, 1 + 2D) rows [count, mean, m2] of
    the ranks, in rank order; a row of count 0 adds nothing."""
    D = (parts.shape[1] - 1) // 2
    n, mean, m2 = parts[0, 0], parts[0, 1:D + 1], parts[0, D + 1:]
    for p in parts[1:]:
        pn, pmean, pm2 = p[0], p[1:D + 1], p[D + 1:]
        tot = n + pn
        w = torch.where(tot > 0, pn / torch.clamp(tot, min=1e-30),
                        torch.zeros_like(tot))
        delta = pmean - mean
        mean = mean + delta * w
        m2 = m2 + pm2 + delta ** 2 * n * w
        n = tot
    return n, mean, m2


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
