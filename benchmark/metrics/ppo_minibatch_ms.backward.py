"""Device ms of a PPO minibatch's span `backward` (the backward pass of
both losses): CUDA events on the stream at the span's ends (the host
clock off the card), the window's seconds over its minibatches; the mean
over ranks. None where the program has no such span."""
from benchmark.span_table import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "epoch/update/backward", "device_s")
