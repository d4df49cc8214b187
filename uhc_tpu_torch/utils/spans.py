"""The port's tracer: named spans and counters inside the training epoch.

`span(name)` is a context manager. Spans nest; a span's path is its
parents' names and its own joined by "/" ("epoch/rollout/obs"), so the
same name under two parents stays two rows. On entry and exit it reads
the host clock and adds the seconds and one call to the row of its path.
`count(name, n)` adds to a counter. Both go to one table per epoch:
`begin()` starts it, `table()` returns it as flat numbers

    <path>.s         host seconds
    <path>.n         calls
    <path>.device_s  device seconds (spans that ask for them)
    count.<name>     counters

which `CopycatAgent.optimize_policy` puts into its stats (and so
`cli/train.py` into metrics.jsonl, and the benchmark into its readings).

While a torch profiler runs (checked at every entry), a span also opens
`torch.profiler.record_function("uhc." + name)`, so it shows in the
profiler's trace on the profiler's own clock, beside the device's
kernels; otherwise a span costs two clock reads and that check.

`span(name, device=dev)` also times the device: on CUDA, events on the
current stream at entry and exit, read by `table()` or `device_seconds()`
after a synchronization the caller has already made (reading waits for
the last event, a wait counted as `host_sync`); elsewhere the host clock
stands in. The tracer adds no synchronization of its own. Spans that
follow one another with no device work between them share their
boundary events (`phases`).

One tracer serves the process (`TRACER`), as one profiler does: the
spans sit in code several layers below the agent that reads the table.
"""
from __future__ import annotations

import time

import torch

PREFIX = "uhc."
SEP = "/"

_clock = time.perf_counter
_profiling = torch._C._autograd._profiler_enabled


class Tracer:
    """The spans' rows {path: [host s, calls, device s]}, the counters
    {name: n} of the current epoch, the stack of open spans' paths, the
    device spans whose events are not read yet, each device span's
    seconds since the process began, by name, the events free to record
    again and each card's current stream."""

    def __init__(self):
        self.rows = {}
        self.counts = {}
        self.stack = []
        self.pending = []
        self.device_totals = {}
        # CUDA events read and free to record again (creating one costs
        # more than recording it), and each card's current stream
        self.events = []
        self.streams = {}

    def begin(self) -> None:
        """Start an epoch's table (what came before is read, into the
        running totals, and dropped)."""
        self._read_events()
        self.rows = {}
        self.counts = {}

    def span(self, name: str, device=None, label=None) -> "_Span":
        return _Span(self, name, device, label)

    def count(self, name: str, n=1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def table(self) -> dict:
        """The epoch's table as flat numbers (see the module's doc)."""
        self._read_events()
        out = {}
        for path, (s, n, dev) in self.rows.items():
            out[path + ".s"] = s
            out[path + ".n"] = n
            if dev is not None:
                out[path + ".device_s"] = dev
        for name, n in self.counts.items():
            out["count." + name] = n
        return out

    def device_seconds(self, prefix: str) -> float:
        """Device seconds of every span whose name starts with `prefix`,
        since the process began."""
        self._read_events()
        return sum(v for k, v in self.device_totals.items()
                   if k.startswith(prefix))

    def _row(self, path: str, device: bool) -> list:
        row = self.rows.get(path)
        if row is None:
            row = self.rows[path] = [0.0, 0, 0.0 if device else None]
        elif device and row[2] is None:
            row[2] = 0.0
        return row

    def _add_device(self, row, name, seconds) -> None:
        row[2] += seconds
        self.device_totals[name] = self.device_totals.get(name, 0.0) + seconds

    def _read_events(self) -> None:
        if not self.pending:
            return
        # events of one stream complete in order: one wait for the last
        self.pending[-1][3].synchronize()
        self.count("host_sync")
        totals, free = self.device_totals, {}
        for row, name, e0, e1 in self.pending:
            dt = e0.elapsed_time(e1) / 1e3
            row[2] += dt
            totals[name] = totals.get(name, 0.0) + dt
            # phases share their boundary events
            free[id(e0)], free[id(e1)] = e0, e1
        self.events += free.values()
        self.pending = []

    def _event(self, device):
        """A CUDA event recorded on `device`'s current stream now (the
        stream object kept while it stays the current one)."""
        idx = device.index
        if idx is None:
            idx = torch.cuda.current_device()
        stream = self.streams.get(idx)
        if stream is None or \
                stream.stream_id != torch._C._cuda_getCurrentStream(idx)[0]:
            stream = self.streams[idx] = torch.cuda.current_stream(idx)
        e = (self.events.pop() if self.events
             else torch.cuda.Event(enable_timing=True))
        e.record(stream)
        return e


class Phases:
    """Device-timed spans that follow one another on one device with no
    device work between them, such as a PPO minibatch's forward, backward
    and optimizer: a phase's end event is the next one's start, so n
    phases record n + 1 events, not 2n. `phases(dev)("forward")` is such
    a span."""
    __slots__ = ("tracer", "device", "last")

    def __init__(self, tracer, device):
        self.tracer, self.device, self.last = tracer, device, None

    def __call__(self, name: str) -> "_Span":
        return _Span(self.tracer, name, self.device, None, self)


class _Span:
    __slots__ = ("tracer", "name", "label", "device", "group", "path",
                 "rf", "e0", "t0")

    def __init__(self, tracer, name, device, label, group=None):
        self.tracer, self.name, self.device = tracer, name, device
        self.label, self.group = label, group

    def __enter__(self):
        tr = self.tracer
        stack = tr.stack
        self.path = stack[-1] + SEP + self.name if stack else self.name
        stack.append(self.path)
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(
                PREFIX + self.name if self.label is None
                else f"{PREFIX}{self.name} {self.label}")
            self.rf.__enter__()
        self.e0 = None
        if self.device is not None and self.device.type == "cuda":
            g = self.group
            self.e0 = (g.last if g is not None and g.last is not None
                       else tr._event(self.device))
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        tr = self.tracer
        row = tr._row(self.path, self.device is not None)
        row[0] += t1 - self.t0
        row[1] += 1
        if self.e0 is not None:
            e1 = tr._event(self.device)
            tr.pending.append((row, self.name, self.e0, e1))
            if self.group is not None:
                self.group.last = e1
        elif self.device is not None:
            tr._add_device(row, self.name, t1 - self.t0)
        tr.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


TRACER = Tracer()


def span(name: str, device=None, label=None) -> _Span:
    """A span `name` of the process's tracer; `device` (a torch.device)
    asks for device seconds; `label` is appended to the profiler's name
    of the span ("uhc.epoch 3"), not to its path."""
    return _Span(TRACER, name, device, label)


def phases(device) -> Phases:
    """A group of back-to-back device-timed spans of the process's
    tracer on `device` (see `Phases`)."""
    return Phases(TRACER, device)


def count(name: str, n=1) -> None:
    """Add `n` to the process's counter `name`."""
    TRACER.count(name, n)


def begin() -> None:
    TRACER.begin()


def table() -> dict:
    return TRACER.table()


def device_seconds(prefix: str) -> float:
    return TRACER.device_seconds(prefix)


def self_seconds(flat: dict) -> dict:
    """{path: host seconds less its children's} from a flat table."""
    total = {k[:-2]: v for k, v in flat.items()
             if k.endswith(".s") and not k.startswith("count.")}
    out = dict(total)
    for path, s in total.items():
        if SEP in path:
            parent = path.rsplit(SEP, 1)[0]
            if parent in out:
                out[parent] -= s
    return out
