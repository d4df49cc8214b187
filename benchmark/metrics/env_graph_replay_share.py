"""Share of the window's env-step calls on the card that replayed a
captured CUDA graph: the program's counter `env_graph.replay` over
`env_graph.replay` + `env_graph.eager`, in %, over the window's epochs,
rank 0. None where the program has neither counter (a program without the
graph, or a run off the card)."""
from benchmark.span_table import per_epoch_counts


def read(ctx):
    st = ctx["ranks"][0]["stats"]
    replay = per_epoch_counts(st, lambda name: name == "env_graph.replay")
    eager = per_epoch_counts(st, lambda name: name == "env_graph.eager")
    if replay is None and eager is None:
        return None
    replay, eager = replay or 0.0, eager or 0.0
    return 100.0 * replay / (replay + eager)
