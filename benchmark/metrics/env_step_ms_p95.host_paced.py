"""95th percentile of the rollout's control-step time: the ms between the
CUDA events recorded at consecutive policy calls of one rollout, over
every step of the window on every rank (pairs across an update left
out; no extra synchronization in the window). The host's launches pace
these steps, and its noise moves the tail from run to run by more than
an end-to-end bound may hold, so it stands here as a per-layer metric."""
import numpy as np


def read(ctx):
    ms = [v for r in ctx["ranks"] for v in r["step_ms"]]
    return float(np.percentile(ms, 95)) if ms else None
