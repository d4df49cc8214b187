"""The control-step kernel's share of its roofline in the traced epoch:
the least time of its steps (the larger of the frozen operation count
over 67 TFLOP/s and its bytes over 3.35 TB/s, per step, the captured
step's contact sets standing for every step) over the summed device time
of `control_step_kernel`, in %, mean over ranks. None where the kernel
did not run."""
from benchmark.counts import PEAK_BYTES_PER_S, PEAK_F32_FLOPS


def read(ctx):
    shares = []
    for r in ctx["ranks"]:
        tr = r.get("trace")
        if not tr or not tr.get("ctrl_kernel_s"):
            return None
        least = tr["steps"] * max(tr["ctrl_flops_step"] / PEAK_F32_FLOPS,
                                  tr["ctrl_bytes_step"] / PEAK_BYTES_PER_S)
        shares.append(100.0 * least / tr["ctrl_kernel_s"])
    return sum(shares) / len(shares)
