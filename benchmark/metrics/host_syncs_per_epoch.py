"""Host synchronizations per epoch: the program's counter `host_sync`
(every site in the epoch where the host waits for the device: the
agent's synchronizations, copies to and from the host, a boolean index,
reading the collectives' events), the mean over the window's epochs,
rank 0. None where the program has no such counter."""
from benchmark.span_table import per_epoch_counts


def read(ctx):
    st = ctx["ranks"][0]["stats"]
    return per_epoch_counts(st, lambda name: name == "host_sync")
