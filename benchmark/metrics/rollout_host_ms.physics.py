"""Host ms a rollout step spends in the program's span `physics` (the env
step up to the control-step kernel's return: the models, the expert
frame, the operands, the launch), over the window's epochs: the span's
seconds over its calls, one a step; the mean over ranks. None where the
program has no such span."""
from benchmark.span_table import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "epoch/rollout/physics")
