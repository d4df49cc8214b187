"""Data-parallel copycat training over `torch.distributed` (the port's
counterpart of the JAX mesh path: uhc_tpu/cli/train.py:31-32,91-94,107
`--data-parallel`, uhc_tpu/learn/agent.py:10-13,48,265-272
`CopycatAgent(mesh=)` with uhc_tpu/learn/ppo.py:11-13, and
__graft_entry__.py:68-113 `dryrun_multichip`).

Under XLA's SPMD the mesh path computes the function one device computes
over the whole batch; here each rank is a process holding `num_envs / W`
envs, and the agent keeps that meaning by hand (learn/running_norm.py,
learn/gae.py, learn/ppo.py, learn/agent.py): the running statistics merge
the global batch at every rollout step, the advantages are whitened over
it, PPO shuffles it and averages gradients over global minibatches, the
gradient clip reads the global norm, the epoch stats and the mining
sampler see every env. Parameters, log-std, statistics and sampler stay
identical on every rank, bit for bit.

Backend rule: `nccl` when each rank has its own card, `gloo` where ranks
share a device (the CPU, or several ranks on one card, a rehearsal whose
contexts time-slice the card: its throughput is no data-parallel speed-up).
The caller names the backend; nothing here switches it. Every collective
is built from `all_reduce` (sum) and `broadcast`, the two the backend
table lists for `gloo` on CUDA tensors as well as on the CPU: a gather is
an all_reduce of a zero-padded (W, ...) buffer whose row r rank r fills,
so all three set-ups run the same code.

`spawn(fn, world_size, device, backend)` runs `fn(dist, *args)` in one
process per rank over a process group on localhost and returns each
rank's result. A rank that raises or dies ends the run: the others,
blocked in a collective, are terminated.

Two limits, kept apart: a collective waits at most the process group's
`timeout` (DEFAULT_TIMEOUT_S, 30 min: longer means a peer hangs), and the
run as a whole has none unless the caller names one (`spawn(wait=)`). The
ranks wait out rank 0's checkpoint and eval in `Dist.barrier`, which polls
the group's TCP store and so holds no collective pending however long the
eval takes.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import socket
import tempfile
import time
import traceback

import torch

from uhc_tpu_torch.utils import spans

# the process group's timeout: a rank blocked in a collective longer than
# this (a peer that died or hangs) raises
DEFAULT_TIMEOUT_S = 1800.0
# the clips of dryrun_multichip
GAIT_CLIPS = "sample_data/gait_clips.pkl"


@dataclasses.dataclass
class Dist:
    """One rank's handle: its rank, the world size, the process group
    (None: the default group) and the device its tensors live on."""
    rank: int
    world_size: int
    device: torch.device
    group: object = None
    store: object = None
    _barriers: int = 0

    @property
    def seconds(self) -> float:
        """Time spent in collectives so far: the device seconds of the
        tracer's `dp.<kind>` spans (utils/spans.py; on CUDA events
        recorded on the stream around each, with no host synchronization
        while they run, and reading waits for the last; else the host
        clock)."""
        return spans.device_seconds("dp.")

    def _timed(self, kind: str, op, t):
        """Run collective `kind` on `t` inside its span `dp.<kind>`,
        counting its calls and bytes."""
        spans.count(f"dp.{kind}.calls")
        spans.count(f"dp.{kind}.bytes", t.numel() * t.element_size())
        with spans.span("dp." + kind, device=self.device):
            op(t)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        return self._timed("all_reduce", self._all_reduce, t)

    def _all_reduce(self, t):
        import torch.distributed as D

        D.all_reduce(t, group=self.group)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank, in place; returns it."""
        import torch.distributed as D

        return self._timed(
            "broadcast", lambda x: D.broadcast(x, src, group=self.group), t)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(W, *x.shape): row r is rank r's `x` (x of one shape and dtype
        on every rank); counted as one `gather` of the (W, ...) buffer,
        the all_reduce it is built from not counted again."""
        buf = torch.zeros((self.world_size, *x.shape), dtype=x.dtype,
                          device=self.device)
        buf[self.rank] = x
        return self._timed("gather", self._all_reduce, buf)

    def barrier(self) -> None:
        """Wait until every rank is here, with no time limit (rank 0's
        checkpoint and eval may outlast the collectives' timeout): each
        rank counts itself in on the group's TCP store and polls the
        count, so no collective is pending meanwhile; then
        torch.distributed.barrier, host-blocking under NCCL too, keeps
        rank 0 (the store's host) until every rank has left the poll. A
        rank that dies meanwhile ends the run through `spawn`."""
        import torch.distributed as D

        key = f"barrier/{self._barriers}"
        self._barriers += 1
        self.store.add(key, 1)
        while self.store.add(key, 0) < self.world_size:
            time.sleep(0.02)
        D.barrier(group=self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(rank: int, world_size: int, backend: str, port: int, device,
         timeout: float = DEFAULT_TIMEOUT_S) -> Dist:
    """Join the process group over the TCP store at 127.0.0.1:`port`
    (rank 0 hosts it) as `rank`; a collective waits at most `timeout`
    seconds. Every rank runs on this host, so gloo and NCCL bootstrap over
    the loopback interface unless the environment names another."""
    import torch.distributed as D

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    limit = datetime.timedelta(seconds=timeout)
    store = D.TCPStore("127.0.0.1", port, world_size, rank == 0,
                       timeout=limit)
    D.init_process_group(backend, store=store, world_size=world_size,
                         rank=rank, timeout=limit)
    return Dist(rank, world_size, torch.device(device), store=store)


def teardown() -> None:
    import torch.distributed as D

    if D.is_initialized():
        D.destroy_process_group()


def rank_device(device, rank: int) -> torch.device:
    """`device` for rank `rank`: "cuda" without an index means a card of
    its own (cuda:rank); "cpu" or "cuda:i" is shared by every rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    return dev


def _worker(rank, world_size, fn, args, device, backend, port, timeout,
            results):
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            # before anything touches CUDA: launches go to the current device
            torch.cuda.set_device(dev)
        d = init(rank, world_size, backend, port, dev, timeout)
        try:
            out = fn(d, *args)
        finally:
            teardown()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, device, backend: str, args=(),
          timeout: float = DEFAULT_TIMEOUT_S, wait: float | None = None
          ) -> list:
    """Run `fn(dist, *args)` on `world_size` ranks, one spawned process
    each, and return their results in rank order. `fn` and `args` are
    pickled (a module-level function). `device`: "cuda" gives rank r the
    card cuda:r (backend "nccl"); "cpu" or "cuda:0" puts every rank on it
    (backend "gloo"). `timeout` bounds each of the process group's
    collectives, `wait` (None: no limit) the wait for the results; a rank
    that fails or dies, or a run past `wait`, ends with a RuntimeError
    after the ranks still running are terminated."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, world_size, fn, args, str(device), backend,
                               port, timeout, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, error = {}, None
    deadline = None if wait is None else time.monotonic() + wait
    try:
        # drain the queue before joining: a writer blocks until read
        while len(out) < world_size and error is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead and results.empty():
                    # a rank that died without a word (killed, crashed)
                    time.sleep(1.0)
                    if results.empty():
                        error = (f"rank(s) {dead} exited with "
                                 f"{[procs[r].exitcode for r in dead]}")
                elif deadline is not None and time.monotonic() > deadline:
                    error = (f"no result from rank(s) "
                             f"{sorted(set(range(world_size)) - set(out))} "
                             f"within {wait} s")
                continue
            if ok:
                out[rank] = value
            else:
                error = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=30.0 if error is None else 1.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
    if error is not None:
        raise RuntimeError(f"data-parallel run failed: {error}")
    return [out[r] for r in range(world_size)]


# -- dryrun_multichip (__graft_entry__.py:68-113) ---------------------------
def dryrun_config():
    """The JAX dry run's small Config: policy and value (64, 64), the
    Gaussian actor, minibatch 64, one optimization pass, fixed std."""
    from uhc_tpu_torch.config.config import Config

    return dataclasses.replace(
        Config.uhc_implicit(), policy_hsize=(64, 64), value_hsize=(64, 64),
        actor_type="gauss", mini_batch_size=64, num_optim_epoch=1,
        fix_std=True)


def _dryrun_rank(d: Dist, n: int, results_dir: str):
    from uhc_tpu_torch.learn.agent import CopycatAgent

    agent = CopycatAgent(dryrun_config(), GAIT_CLIPS, num_envs=2 * n,
                         horizon=3, max_seq_len=20, results_dir=results_dir,
                         dist=d)
    stats = agent.optimize_policy(0)
    for k, v in stats.items():
        if not torch.isfinite(torch.as_tensor(v)).all():
            raise RuntimeError(f"dryrun_multichip: {k} = {v} not finite")
    return stats


def dryrun_multichip(n: int, device="cpu", backend: str = "gloo",
                     wait: float = 600.0) -> dict:
    """One full data-parallel training step (rollout of 2·n envs × 3 steps,
    GAE, PPO) on n ranks with the JAX dry run's config and the gait clips
    cut to 20 frames, within `wait` seconds; returns rank 0's stats. On
    the CPU over gloo by default; on cards, device="cuda" with
    backend="nccl" (a card a rank)."""
    with tempfile.TemporaryDirectory() as out:
        stats = spawn(_dryrun_rank, n, device, backend, args=(n, out),
                      wait=wait)[0]
    print("dryrun_multichip ok:", {k: v for k, v in stats.items()
                                   if k in ("reward_mean", "steps")})
    return stats
