"""Host ms a rollout step spends in the program's span `obs` (the step's
observation, the running statistics' update with the ranks' merge, and
the normalization), over the window's epochs: the span's seconds over
its calls, one a step; the mean over ranks. None where the program has
no such span."""
from benchmark.span_table import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "epoch/rollout/obs")
