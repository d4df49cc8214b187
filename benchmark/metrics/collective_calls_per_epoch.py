"""Collective calls a rank makes per epoch, every kind together: the
program's counters `dp.<kind>.calls` (all_reduce, broadcast, gather),
the mean over the window's epochs and the ranks. None on one card, and
where the program has no such counters."""
from benchmark.span_table import per_epoch_counts


def read(ctx):
    ranks = ctx["ranks"]
    if len(ranks) < 2:
        return None
    per = [per_epoch_counts(r["stats"], lambda name: name.startswith("dp.")
                            and name.endswith(".calls")) for r in ranks]
    if None in per:
        return None
    return sum(per) / len(per)
