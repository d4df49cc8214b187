"""Training throughput: every env step of the window's whole epochs (all
ranks) over the wall time of those epochs, rollout, GAE, PPO and the
sampler's update included (host clock; each epoch ends synchronized)."""


def read(ctx):
    r0 = ctx["ranks"][0]
    steps = sum(s["steps"] for s in r0["stats"])
    return steps / r0["window_s"]
