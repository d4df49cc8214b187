"""Host ms per epoch in the program's span `tail`: after the update, the
epoch stats' reduction to the host, the sampler's telemetry and update,
and on several ranks the replicas' digest; the mean over the window's
epochs and the ranks. None where the program has no such span."""
from benchmark.span_table import per_epoch_ms


def read(ctx):
    return per_epoch_ms(ctx, "epoch/tail")
