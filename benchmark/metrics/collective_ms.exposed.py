"""Collective time per epoch per rank, from the program's own counter
(`Dist.seconds`, CUDA events around each collective, so the wait for the
slowest rank is in it): the mean over the window's epochs and the ranks.
None on one card."""


def read(ctx):
    ranks = ctx["ranks"]
    if len(ranks) < 2:
        return None
    per = [sum(s["T_collectives"] for s in r["stats"]) / len(r["stats"])
           for r in ranks]
    return 1e3 * sum(per) / len(per)
