"""Device kernels of the traced epoch's rollout (torch.profiler) per
rollout step (rank 0)."""


def read(ctx):
    tr = ctx["ranks"][0].get("trace")
    if not tr or not tr.get("rollout_kernels"):
        return None
    return tr["rollout_kernels"] / tr["steps"]
