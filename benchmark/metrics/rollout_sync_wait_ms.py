"""Host ms per epoch in the program's span `rollout.sync`: the agent's
synchronization after the rollout, which waits out the device's backlog
when the host has finished enqueueing the rollout's work; the mean over
the window's epochs and the ranks. None where the program has no such
span."""
from benchmark.span_table import per_epoch_ms


def read(ctx):
    return per_epoch_ms(ctx, "epoch/rollout.sync")
