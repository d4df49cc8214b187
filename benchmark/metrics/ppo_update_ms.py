"""GAE + PPO, from the agent's own T_update: ms per epoch, the mean over
the window's epochs (rank 0; the ranks' updates end together)."""


def read(ctx):
    st = ctx["ranks"][0]["stats"]
    return 1e3 * sum(s["T_update"] for s in st) / len(st)
