"""The device's idle share of a training epoch: 1 - the device's busy time
in the traced epoch (the union of its operation intervals) over the mean
time of the window's untraced epochs, in %, mean over ranks. The
profiler's host cost stretches the traced epoch itself (the result line's
`trace_stretch`), so its own span would count that cost as idle."""


def read(ctx):
    shares = []
    for r in ctx["ranks"]:
        t = r.get("trace")
        if not t or not r["stats"]:
            return None
        epoch_s = sum(s["T_total"] for s in r["stats"]) / len(r["stats"])
        shares.append(100.0 * (1.0 - t["busy_s"] / epoch_s))
    return sum(shares) / len(shares)
