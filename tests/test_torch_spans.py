"""The port's tracer (uhc_tpu_torch/utils/spans.py): spans nest and give
self times, counters accumulate and the table starts anew each epoch,
the profiler's annotation opens only while a profiler runs, and a tiny
CPU epoch of the copycat agent returns the span table in its stats."""
import dataclasses

import pytest
import torch

from test_torch_helpers import few_threads, host_sync_sites
from uhc_tpu_torch.utils import spans

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

ENVS, HORIZON, MINIBATCH, PASSES = 8, 4, 8, 2


def test_spans_nest_and_give_self_times():
    t = spans.Tracer()
    t.begin()
    with t.span("a"):
        for _ in range(2):
            with t.span("b"):
                with t.span("c"):
                    sum(range(1000))
        with t.span("b.sync"):
            pass
    got = t.table()
    assert {k for k in got if k.endswith(".n")} == {
        "a.n", "a/b.n", "a/b/c.n", "a/b.sync.n"}
    assert (got["a.n"], got["a/b.n"], got["a/b/c.n"]) == (1, 2, 2)
    own = spans.self_seconds(got)
    assert own["a"] == got["a.s"] - got["a/b.s"] - got["a/b.sync.s"]
    assert own["a/b"] == got["a/b.s"] - got["a/b/c.s"]
    assert own["a/b/c"] == got["a/b/c.s"]
    assert got["a.s"] >= got["a/b.s"] >= got["a/b/c.s"] > 0
    assert t.stack == []


def test_counters_accumulate_and_the_table_starts_anew():
    t = spans.Tracer()
    t.begin()
    t.count("x")
    t.count("x", 3)
    with t.span("s"):
        t.count("y", 2)
    got = t.table()
    assert (got["count.x"], got["count.y"], got["s.n"]) == (4, 2, 1)
    t.begin()
    assert t.table() == {}


def test_a_span_that_raises_still_closes():
    t = spans.Tracer()
    with pytest.raises(ValueError):
        with t.span("a"):
            with t.span("b"):
                raise ValueError
    assert t.stack == [] and t.table()["a/b.n"] == 1


def test_device_span_off_the_card_reads_the_host_clock():
    t = spans.Tracer()
    cpu = torch.device("cpu")
    for _ in range(3):
        with t.span("dp.all_reduce", device=cpu):
            torch.ones(8).sum()
    got = t.table()
    assert got["dp.all_reduce.device_s"] == pytest.approx(
        got["dp.all_reduce.s"])
    assert t.device_seconds("dp.") == pytest.approx(got["dp.all_reduce.s"])
    # the running total outlives the epoch's table
    t.begin()
    assert t.device_seconds("dp.") == pytest.approx(got["dp.all_reduce.s"])
    assert "count.host_sync" not in got       # no event to wait for


def test_device_span_on_a_card_reads_its_events_after_the_epoch(
        monkeypatch):
    """On CUDA a device span records an event at each end and waits for
    none; the table waits once, for the last, counts that wait, and the
    events are recorded again in the next epoch (stand-in events: this
    host has no card)."""
    import time

    made = []

    class Event:
        def __init__(self, enable_timing=False):
            self.at, self.waits = None, 0
            made.append(self)

        def record(self, stream=None):
            self.at = time.perf_counter()

        def synchronize(self):
            self.waits += 1

        def elapsed_time(self, end):
            return (end.at - self.at) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    class Stream:
        stream_id = 7

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: Stream())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentStream",
                        lambda idx: (7, idx, 1), raising=False)
    t = spans.Tracer()
    cuda = torch.device("cuda", 0)
    for epoch in range(2):
        t.begin()
        for _ in range(3):
            with t.span("forward", device=cuda):
                sum(range(1000))
        # back-to-back phases share their boundary events: 3 + 1
        phase = spans.Phases(t, cuda)
        for name in ("a", "b", "c"):
            with phase(name):
                sum(range(1000))
        assert len(made) == 6 + 4 and sum(e.waits for e in made) == epoch
        got = t.table()
        assert sum(e.waits for e in made) == epoch + 1
        assert got["count.host_sync"] == 1 and got["forward.n"] == 3
        assert got["forward.device_s"] > 0
        assert all(got[f"{n}.device_s"] > 0 for n in "abc")
        assert len(t.events) == 10


def _nested_spans(t):
    with t.span("epoch", label=7):
        with t.span("rollout"):
            with t.span("obs"):
                torch.ones(4).add_(1)


def test_profiler_annotation_only_while_a_profiler_runs(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    t = spans.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nested_spans(t)
    events = {e.name: e for e in prof.events()}
    assert {"uhc.epoch 7", "uhc.rollout", "uhc.obs"} <= set(events)
    chain, e = [], events["uhc.obs"]
    while e is not None:
        chain.append(e.name)
        e = e.cpu_parent
    assert chain[:3] == ["uhc.obs", "uhc.rollout", "uhc.epoch 7"]
    assert t.table()["epoch/rollout/obs.n"] == 1

    def refuse(*a, **k):
        raise AssertionError("record_function opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _nested_spans(t)
    assert t.table()["epoch/rollout/obs.n"] == 2


@pytest.fixture(scope="module")
def epoch():
    """One CPU epoch of a narrow copycat agent, ENVS × HORIZON, PASSES
    passes over minibatches of MINIBATCH rows: (agent, stats, the
    functions that counted host_sync and how often)."""
    import tempfile

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn.agent import CopycatAgent

    cfg = dataclasses.replace(
        Config.uhc_implicit(), policy_hsize=(32, 16), composer_dim=(16, 8),
        num_primitive=3, value_hsize=(32, 16), mini_batch_size=MINIBATCH,
        num_optim_epoch=PASSES)
    with tempfile.TemporaryDirectory() as out:
        a = CopycatAgent(cfg, "sample_data/gait_clips.pkl", num_envs=ENVS,
                         horizon=HORIZON, seed=3, max_seq_len=20,
                         results_dir=out, device="cpu")
        with host_sync_sites() as sites:
            st = a.optimize_policy(0)
        return a, st, sites


def test_agent_epoch_returns_the_span_table(epoch):
    _, st, _ = epoch
    at = "epoch/rollout/"
    phases = ["reset", "obs", "policy", "physics", "post"]
    for p in phases:
        assert st[at + p + ".n"] == HORIZON, p
    assert sum(st[at + p + ".s"] for p in phases) <= st["T_rollout"]
    assert st["T_rollout"] == st["epoch/rollout.s"] + \
        st["epoch/rollout.sync.s"]
    assert st["T_update"] == st["epoch/update.s"]
    assert st["T_total"] == st["epoch.s"]
    assert st["T_total"] >= st["T_rollout"] + st["T_update"]
    assert st["T_total"] >= st["T_rollout"] + st["T_update"] + \
        st["epoch/tail.s"]
    # the post-step observation, thrown away, and the next step's: 2 a
    # step, and the bootstrap's after the last
    assert st[at + "post/obs.n"] == HORIZON
    assert st["count.obs"] == 2 * HORIZON + 1
    n_mb = PASSES * (ENVS * HORIZON // MINIBATCH)
    for p in ("forward", "backward", "optimizer"):
        assert st[f"epoch/update/{p}.n"] == n_mb, p
        # off the card the host clock stands in for the device's
        assert st[f"epoch/update/{p}.device_s"] == \
            st[f"epoch/update/{p}.s"]
    assert "epoch/update/exchange.n" not in st
    assert st["epoch/update/gae.n"] == 1
    # no kernel launches off the card, no collective on one process
    assert not [k for k in st if k.startswith(("count.launch.",
                                               "count.dp."))]
    assert "T_collectives" not in st


def test_agent_epoch_counts_its_host_synchronizations(epoch):
    """Every site where the host waits on a card, counted on the CPU too:
    the agent's (the sampler's two copies to the device, the two
    synchronizations, the stats' two copies back, the telemetry's four)
    and the small tensors that the observation, the reward, the reset
    and the running statistics copy from the host at every step (the
    plain physics chain, which the CPU runs in place of the kernel,
    counts its own)."""
    _, st, sites = epoch
    assert st["count.host_sync"] == sum(sites.values())
    assert {k: n for k, n in sites.items() if k[0] == "agent.py"} == {
        ("agent.py", "_collect"): 2, ("agent.py", "_sync"): 2,
        ("agent.py", "_epoch_stats"): 2, ("agent.py", "_telemetry"): 4}
    # once a step (the running statistics, the reward's weights) and once
    # more for the bootstrap observation (its heading's base rotation)
    assert sites["running_norm.py", "_moments"] == HORIZON
    assert sites["reward_function.py", "_weighted"] == HORIZON
    assert sites["humanoid_im.py", "obs_v12"] == 2 * HORIZON + 1
    assert {"quat_conj", "heading_quat", "match_heading_and_pos",
            "_ee"} <= {f for _, f in sites}


def test_the_next_epoch_starts_a_new_table(epoch):
    a, st, _ = epoch
    st2 = a.optimize_policy(1)
    assert st2["count.obs"] == st["count.obs"]
    assert st2["epoch/rollout/policy.n"] == HORIZON
