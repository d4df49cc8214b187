"""The whole training step's share of the float32 peak (67 TFLOP/s, TF32
off): an epoch's operations by the frozen counts (physics, the policy and
value forward on every rollout row, PPO's forward and backward on every
minibatch row of every pass) over the mean time of the window's untraced
epochs (not the traced epoch, which the profiler stretches), in %, mean
over ranks. The card's power limit is printed beside it in
`device.power_limit`."""
from benchmark.counts import PEAK_F32_FLOPS


def read(ctx):
    shares = []
    for r in ctx["ranks"]:
        t = r.get("trace")
        if not t or "epoch_flops" not in t or not r["stats"]:
            return None
        epoch_s = sum(s["T_total"] for s in r["stats"]) / len(r["stats"])
        shares.append(100.0 * t["epoch_flops"] / (epoch_s * PEAK_F32_FLOPS))
    return sum(shares) / len(shares)
