"""The batched copycat env step, replayed as a CUDA graph.

`humanoid_im.make_env_step_batched` returns an `EnvStep`: its body (the
model gather, the expert frame, the control-step kernel, termination,
reward and the post-step observation) is ~2,500 small launches, which the
host pays for at every step. On a card, with a control-step kernel
(`physics.control_step.ControlStep`: K1, K1d, K1e, K1f) running the
physics and autograd off, a call whose `signature` has been seen before
replays a captured graph of the body instead: the call copies the state
and the action into the graph's static buffers, replays, and clones the
outputs out, so a tensor it returns is never written again (the rollout
keeps every step's, and a caller may keep one for the whole epoch).

What decides is only what the call's inputs show, one rule for every
caller (training, evaluation, the tools, data parallel, where each rank
holds its own graphs): a signature's first sighting runs eagerly, its
second is captured (after a warm-up call on a side stream, into the
graph's private memory pool) and every later one replays. The CPU, the
plain chain, K2's head / tail split and torque control run eagerly, as
does a call with autograd on. A step keeps at most `GRAPHS_KEPT` graphs,
the least recently used dropped first, so one-off shapes stay eager
rather than filling the card's memory.

A replay runs the kernels the eager body launches, in the same order, on
the same inputs, so its numbers are the eager path's, bit for bit. The
tracer counts `env_graph.replay`, `env_graph.capture` and
`env_graph.eager` (calls on a card that ran eagerly); a replay runs in
the spans `physics` (the copies in and the replay) and `post` (the copies
out), and counts again what the captured body counted (its `obs`, the
kernel's launch in `control_step.LAUNCHES`).
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from uhc_tpu_torch.utils.spans import aside, count, span

GRAPHS_KEPT = 4         # captured graphs a step keeps
SEEN_KEPT = 64          # signatures seen once that a step remembers


def _shape(x):
    """A leaf the graph copies in: its shape and dtype."""
    return None if x is None else (tuple(x.shape), x.dtype)


def _place(x):
    """A tensor the graph reads where it lies: its address and layout."""
    if not isinstance(x, torch.Tensor):
        return x
    return (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)


def signature(model, states, actions, expert_lib, jpos_diffw, body_diffw,
              rfc_rate, train, kernel: bool) -> tuple:
    """What a captured env step depends on, read off its inputs: the
    device and whether a kernel runs the physics; the shape and dtype of
    each state leaf (None where a leaf is absent) and of the action, which
    are copied in; `train`; `rfc_rate`, a launch argument of the kernel;
    and where each tensor the step reads in place lies (the model or
    model library, the expert library, the two weight vectors). Two calls
    with equal signatures can replay one graph."""
    return (states.qpos.device, kernel,
            tuple(_shape(getattr(states, f.name))
                  for f in dataclasses.fields(states)),
            _shape(actions), bool(train), float(rfc_rate),
            tuple(_place(getattr(model, f.name))
                  for f in dataclasses.fields(model)),
            tuple((k, _place(v)) for k, v in expert_lib.items()),
            _place(jpos_diffw), _place(body_diffw))


class _Captured:
    """One captured body: the graph, its static inputs (the state's leaves
    and the action), its static outputs, where each output of the body
    comes from (an input returned as it came, or a static output), what
    the capture counted, and the kernel's workspace the graph writes."""
    __slots__ = ("graph", "ins", "outs", "plan", "counts", "launches",
                 "workspace")


class EnvStep:
    """The batched env step (`humanoid_im.make_env_step_batched`):
    `body(model, states, actions, expert_lib, jpos_diffw, body_diffw,
    rfc_rate, train)` run eagerly, or, where `kernel` is a ControlStep,
    replayed as a graph (see the module's doc). `kernel` is the wrapper
    the body launches, None for the plain chain."""

    def __init__(self, body, kernel):
        from uhc_tpu_torch.physics.control_step import ControlStep

        self.body, self.kernel = body, kernel
        self.capturable = isinstance(kernel, ControlStep)
        self.graphs = collections.OrderedDict()
        self.seen = collections.OrderedDict()
        self.streams = {}

    def __call__(self, model, states, actions, expert_lib, jpos_diffw,
                 body_diffw, rfc_rate=1.0, train: bool = True):
        args = (model, states, actions, expert_lib, jpos_diffw, body_diffw,
                rfc_rate, train)
        if states.qpos.device.type != "cuda":
            return self.body(*args)
        if not self.capturable or torch.is_grad_enabled():
            count("env_graph.eager")
            return self.body(*args)
        sig = signature(*args, kernel=self.kernel is not None)
        g = self.graphs.get(sig)
        if g is not None:
            self.graphs.move_to_end(sig)
            count("env_graph.replay")
            with span("physics"):
                self._replay(g, states, actions)
            with span("post"):
                return self._outputs(g, states, actions)
        if sig not in self.seen:
            self.seen[sig] = None
            if len(self.seen) > SEEN_KEPT:
                self.seen.popitem(last=False)
            count("env_graph.eager")
            return self.body(*args)
        del self.seen[sig]
        g = self._capture(*args)
        self._keep(sig, g, states.qpos.device)
        count("env_graph.capture")
        self._replay(g, states, actions)
        return self._outputs(g, states, actions)

    def _capture(self, model, states, actions, expert_lib, jpos_diffw,
                 body_diffw, rfc_rate, train) -> _Captured:
        from uhc_tpu_torch.physics.control_step import LAUNCHES

        dev = states.qpos.device
        names = [f.name for f in dataclasses.fields(states)]
        g = _Captured()
        g.ins = [None if getattr(states, n) is None
                 else getattr(states, n).clone() for n in names]
        g.ins.append(actions.clone())
        st = type(states)(**dict(zip(names, g.ins)))
        rest = (expert_lib, jpos_diffw, body_diffw, rfc_rate, train)
        cur = torch.cuda.current_stream(dev)
        side = self.streams.get(dev)
        if side is None:
            side = self.streams[dev] = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            # the warm-up, an eager call as any other
            self.body(model, st, g.ins[-1], *rest)
            before = collections.Counter(LAUNCHES)
            # a capture runs nothing: what it counts is set aside, and
            # counted again at each replay
            with aside() as g.counts:
                g.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.body(model, st, g.ins[-1], *rest)
                finally:
                    g.graph.capture_end()
            g.launches = LAUNCHES - before
            LAUNCHES.subtract(g.launches)
        cur.wait_stream(side)
        # a bigger batch later gets a new workspace: the graph keeps its own
        g.workspace = self.kernel.workspace(states.qpos.shape[0], dev)
        state, rest_out = out[0], out[1:]
        flat = [getattr(state, n) for n in names] + list(rest_out)
        given = {id(t): i for i, t in enumerate(g.ins) if t is not None}
        made, g.outs, g.plan = {}, [], []
        for t in flat:
            if t is None:
                g.plan.append(None)
            elif id(t) in given:
                g.plan.append((True, given[id(t)]))
            else:
                if id(t) not in made:
                    made[id(t)] = len(g.outs)
                    g.outs.append(t)
                g.plan.append((False, made[id(t)]))
        return g

    def _keep(self, sig, g, dev) -> None:
        self.graphs[sig] = g
        if len(self.graphs) > GRAPHS_KEPT:
            # the dropped graph's last replay may still be running: let it
            # end before its graph and buffers go
            count("host_sync")
            torch.cuda.current_stream(dev).synchronize()
            self.graphs.popitem(last=False)

    @staticmethod
    def _replay(g, states, actions) -> None:
        """The inputs copied into the graph's buffers, the replay, and
        what the captured body counted, counted again."""
        from uhc_tpu_torch.physics.control_step import LAUNCHES

        for dst, f in zip(g.ins, dataclasses.fields(states)):
            if dst is not None:
                dst.copy_(getattr(states, f.name))
        g.ins[-1].copy_(actions)
        g.graph.replay()
        for name, n in g.counts.items():
            count(name, n)
        LAUNCHES.update(g.launches)

    @staticmethod
    def _outputs(g, states, actions):
        """(state, obs, reward, terms, done) of the last replay: each
        output the body made, cloned out of the graph's buffers; each it
        returned as it came, the caller's own tensor."""
        names = [f.name for f in dataclasses.fields(states)]
        given = [getattr(states, n) for n in names] + [actions]
        made = [t.clone() for t in g.outs]
        flat = [None if p is None else (given if p[0] else made)[p[1]]
                for p in g.plan]
        state = type(states)(**dict(zip(names, flat[:len(names)])))
        return (state, *flat[len(names):])
