"""The readers of the program's span table: a tiny traced run on the CPU
prints every single-card one as a finite number and neither
collective one; each reader's arithmetic on made-up stats, and None
where the program has no such span or counter."""
import math
import time

import pytest

from benchmark import run, session, spec
from benchmark.tests.tiny import TINY, TINY_LIMITS, tiny_bench, tiny_here

SINGLE = ["rollout_host_ms.reset", "rollout_host_ms.obs",
          "rollout_host_ms.policy", "rollout_host_ms.physics",
          "rollout_host_ms.post", "rollout_sync_wait_ms",
          "ppo_minibatch_ms.forward", "ppo_minibatch_ms.backward",
          "ppo_minibatch_ms.optimizer", "epoch_tail_ms",
          "host_syncs_per_epoch"]
DP = ["collective_mb_per_epoch", "collective_calls_per_epoch"]


def test_traced_tiny_run_reads_every_span_metric(tmp_path):
    here = tiny_here(tmp_path, limits=TINY_LIMITS)
    cell = spec.cell("tiny", tiny_bench(), here)
    assert {m["name"] for m in cell.per_layer} >= set(SINGLE)
    assert not {m["name"] for m in cell.per_layer} & set(DP)
    ranks = [session.run_rank(None, cell, 2**31 + 11, 0.5, True,
                              time.time(), "cpu")]
    out = run.result(cell, ranks, True, "cpu", 1)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in SINGLE:
        assert math.isfinite(got[name]["value"]), name
        assert got[name]["value"] >= 0, name
    assert not set(got) & set(DP)
    # every reader of a dp-only metric also finds nothing on one rank
    ctx = {"ranks": ranks}
    for name in DP:
        assert spec.reader(name, here)(ctx) is None
    # a rollout step's observation runs once in `obs` and once in `post`
    st = ranks[0]["stats"][0]
    h = TINY["horizon"]
    assert st["epoch/rollout/obs.n"] == st["epoch/rollout/post/obs.n"] == h
    n_mb = TINY["num_optim_epoch"] * (
        TINY["envs_per_rank"] * h // TINY["mini_batch_size"])
    assert st["epoch/update/forward.n"] == n_mb


def _stats(**over):
    """One epoch's made-up stats: every span of the table, 2 calls."""
    s = {}
    for path in ("epoch/rollout/reset", "epoch/rollout/obs",
                 "epoch/rollout/policy", "epoch/rollout/physics",
                 "epoch/rollout/post", "epoch/rollout.sync", "epoch/tail",
                 "epoch/update/forward", "epoch/update/backward",
                 "epoch/update/optimizer"):
        s[path + ".s"], s[path + ".n"] = 0.004, 2
        s[path + ".device_s"] = 0.006
    s["count.host_sync"] = 7
    return {**s, **over}


@pytest.mark.parametrize("name,stats,want", [
    # (0.004 + 0.008) s over 4 calls
    ("rollout_host_ms.reset",
     [_stats(), _stats(**{"epoch/rollout/reset.s": 0.008})], 3.0),
    ("rollout_host_ms.obs", [_stats()], 2.0),
    ("rollout_host_ms.policy", [_stats()], 2.0),
    ("rollout_host_ms.physics", [_stats()], 2.0),
    ("rollout_host_ms.post", [_stats()], 2.0),
    # per epoch, not per call
    ("rollout_sync_wait_ms", [_stats(), _stats()], 4.0),
    ("epoch_tail_ms", [_stats()], 4.0),
    # device seconds over minibatches
    ("ppo_minibatch_ms.forward", [_stats()], 3.0),
    ("ppo_minibatch_ms.backward", [_stats()], 3.0),
    ("ppo_minibatch_ms.optimizer",
     [_stats(**{"epoch/update/optimizer.n": 3})], 2.0),
    # rank 0's
    ("host_syncs_per_epoch",
     [_stats(), _stats(**{"count.host_sync": 9})], 8.0),
])
def test_reader_arithmetic(name, stats, want):
    read = spec.reader(name)
    assert read({"ranks": [{"stats": stats}]}) == pytest.approx(want)
    # a second rank reading twice as much: the mean over ranks, or rank
    # 0's alone
    other = [{**s, **{k: 2 * v for k, v in s.items()
                      if k.endswith("_s") or k.endswith(".s")
                      or k.startswith("count.")}} for s in stats]
    two = want if name == "host_syncs_per_epoch" else 1.5 * want
    assert read({"ranks": [{"stats": stats}, {"stats": other}]}) == \
        pytest.approx(two)
    # a program without the span or counter
    assert read({"ranks": [{"stats": [{"T_total": 1.0}]}]}) is None


def test_collective_readers():
    def rank(ar_bytes, calls):
        return {"stats": [{"count.dp.all_reduce.bytes": ar_bytes,
                           "count.dp.all_reduce.calls": calls,
                           "count.dp.gather.bytes": 1e6,
                           "count.dp.gather.calls": 48,
                           "count.host_sync": 3}]}

    ranks = [rank(2e6, 10), rank(4e6, 12)]
    mb = spec.reader("collective_mb_per_epoch")
    calls = spec.reader("collective_calls_per_epoch")
    assert mb({"ranks": ranks}) == pytest.approx(4.0)
    assert calls({"ranks": ranks}) == pytest.approx(59.0)
    assert mb({"ranks": ranks[:1]}) is None
    assert calls({"ranks": ranks[:1]}) is None
    bare = [{"stats": [{"T_total": 1.0}]}] * 2
    assert mb({"ranks": bare}) is None and calls({"ranks": bare}) is None
