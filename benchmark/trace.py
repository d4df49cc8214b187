"""The traced epoch: one steady epoch after the window under torch.profiler
(CPU and CUDA activity), reduced at once to sums; no trace file is kept.

- busy_s: the union of the device's operation intervals (kernels, copies,
  sets) within the epoch; window_s: the epoch's span on the host;
- rollout_kernels: the device kernels of the rollout: those that start
  between the rollout's span and the end of the synchronization that
  follows it (the agent synchronizes after every rollout);
- ctrl_kernel_s: the summed device time of `control_step_kernel`;
- device_ops: the ten kernels by summed device time; idle_gaps: the ten
  longest gaps between device operations, each named by the innermost
  host operation running when it began."""
from __future__ import annotations

import time

ROLLOUT, EPOCH = "bench.rollout", "bench.epoch"
SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")
# the profiler's own host events, which name no work of the program
PROFILER_OWN = ("Activity Buffer Request",)


def profile_epoch(agent, probe, epoch: int, dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    probe.spans = True
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(EPOCH):
            agent.optimize_policy(epoch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        host_s = time.perf_counter() - t0
    probe.spans = False
    return reduce(prof.events(), host_s)


def _span(events, name):
    """The host time range of the first host event called `name`."""
    hits = [e for e in events if e.name == name and not
            str(getattr(e, "device_type", "")).endswith("CUDA")]
    return (hits[0].time_range.start, hits[0].time_range.end) if hits \
        else None


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set, not the device-side
    range of a host annotation (record_function, the optimizer's step)."""
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("bench.", "Optimizer.")))


def reduce(events, host_s: float) -> dict:
    """Sums of one profiled epoch (times in seconds)."""
    ep = _span(events, EPOCH)
    ro = _span(events, ROLLOUT)
    dev = sorted((e for e in events if _is_device(e)),
                 key=lambda e: e.time_range.start)
    if ep is not None:
        dev = [e for e in dev if ep[0] <= e.time_range.start <= ep[1]]
    # the union of the device's intervals, and the gaps between them
    busy, gaps, cur = 0.0, [], None
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        if cur is None:
            cur = [s, t]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    kernels = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    rollout_kernels = None
    if ro is not None:
        ends = [e.time_range.end for e in events
                if e.name in SYNCS and e.time_range.start >= ro[1]]
        stop = min(ends) if ends else ro[1]
        rollout_kernels = sum(
            1 for e in dev if ro[0] <= e.time_range.start <= stop
            and not e.name.startswith(("Memcpy", "Memset")))
    host = [e for e in events if not str(getattr(
        e, "device_type", "")).endswith("CUDA")
        and e.name not in PROFILER_OWN]
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inner = [e for e in host
                 if e.time_range.start <= g0 <= e.time_range.end
                 and e.name not in (EPOCH, ROLLOUT)]
        label = (min(inner, key=lambda e: e.time_range.end
                     - e.time_range.start).name if inner else "host")
        named.append([label, (g1 - g0) / 1e6])
    window_us = (ep[1] - ep[0]) if ep is not None else host_s * 1e6
    return {
        "busy_s": busy / 1e6, "window_s": window_us / 1e6,
        "rollout_kernels": rollout_kernels,
        "ctrl_kernel_s": sum(v for k, v in kernels.items()
                             if "control_step_kernel" in k) / 1e6,
        "device_ops": [[k, v / 1e6] for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": named}
