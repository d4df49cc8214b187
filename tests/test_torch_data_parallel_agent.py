"""Data-parallel CopycatAgent on the CPU over gloo, two spawned ranks: an
epoch equal to the single-process epoch over the concatenated envs, ranks
identical bit for bit across epochs, a checkpoint and a resume, rank 0's
checkpoint through JAX and the port, and dryrun_multichip(2). Each rank
runs two torch threads; every spawn waits at most SPAWN_S seconds."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_dp_ranks as R
from test_torch_helpers import close, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

SPAWN_S = 300.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of test_torch_dp_ranks.agent_rank (one spawn) and
    the directory they wrote to."""
    from uhc_tpu_torch.learn import data_parallel as DP

    out = str(tmp_path_factory.mktemp("dp"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        return DP.spawn(R.agent_rank, 2, "cpu", "gloo", args=(out,),
                        wait=SPAWN_S), out


def test_epoch_equals_the_single_process_epoch(ranks, tmp_path):
    """One epoch with exploration off (every action the mean) from fixed
    states in which no env ends and warm statistics
    (test_torch_dp_ranks.warm_stats), on 2 ranks of 2 envs, against one
    process over the 4 envs: value params within 2·lr per Adam step (2
    passes of one minibatch; the PPO bounds of tests/test_torch_train.py),
    and the value params' change within 1e-3 of the single process's
    change in norm (7.0e-7 here; Adam hides a gradient's scale, not its
    direction: merging rank 0's rows alone into the statistics gives
    2.9e-2); the policy unmoved on both (no exploring row); the
    statistics' mean within 1e-5 of each dim's scale
    (the RMS of the values it has seen) and m2 within 1e-5 of m2 + n·mean²
    (the rollouts' second and third steps differ by float32 rounding:
    1.9e-6 and 1.2e-6 here; the merge alone is held at 1e-6 in
    test_torch_data_parallel.py), the stats within 1e-5 relative."""
    res, _ = ranks
    a = R.agent(R.agent_cfg(explore=False), str(tmp_path))
    policy0, value0 = (R.snapshot(a)[k] for k in ("policy", "value"))
    a.rs = R.warm_stats(a.obs_dim)
    a.env_states = R.fixed_states(a)
    st = a.optimize_policy(0)
    want = R.snapshot(a)
    got = res[0]["still"]
    assert got["dones"] == 0 and st["episodes"] == 0
    lr = a.cfg.value_lr
    for x, y in zip(jax_leaves(want["value"]), jax_leaves(got["value"])):
        close(x, y, 2 * lr * a.cfg.num_optim_epoch)
    moved = [np.concatenate([(np.asarray(x, np.float64) - y).ravel()
                             for x, y in zip(jax_leaves(v),
                                             jax_leaves(value0))])
             for v in (want["value"], got["value"])]
    assert np.linalg.norm(moved[1] - moved[0]) <= \
        1e-3 * np.linalg.norm(moved[0])
    for p in (want["policy"], got["policy"]):
        for x, y in zip(jax_leaves(policy0), jax_leaves(p)):
            np.testing.assert_array_equal(x, y)
    n, mean, m2 = (want["rs"][k].astype(np.float64)
                   for k in ("n", "mean", "m2"))
    assert got["rs"]["n"] == n
    close(mean, got["rs"]["mean"], 1e-5 * np.sqrt(m2 / n + mean ** 2))
    close(m2, got["rs"]["m2"], 1e-5 * (m2 + n * mean ** 2))
    for k in ("reward_mean", "c_reward_mean", "avg_eps_len",
              "value_loss_before", "value_loss", "policy_loss"):
        close(st[k], got["stats"][k], 0.0, 1e-5)
    close(st["reward_terms"], got["stats"]["reward_terms"], 0.0, 1e-5)
    assert got["stats"]["steps"] == st["steps"] == R.HORIZON * R.ENVS
    assert got["stats"]["rank_rollout_steps_per_sec"] > 0


def jax_leaves(tree):
    import jax

    return jax.tree.leaves(tree)


def test_ranks_stay_identical_through_a_resume(ranks):
    """Two exploring epochs (some episodes end and restart), rank 0's
    checkpoint, a resume on every rank from it and one more epoch: every
    epoch's digest of parameters, log-std, statistics and sampler is the
    same on both ranks, and the resumed agents start from the saved
    digest."""
    res, _ = ranks
    r0, r1 = res[0]["run"], res[1]["run"]
    assert len(r0["digests"]) == 2 and r0["digests"] == r1["digests"]
    assert r0["loaded"] == r1["loaded"] == r0["digests"][-1]
    assert len(r0["resumed"]) == 1 and r0["resumed"] == r1["resumed"]
    assert r0["episodes"] > 0
    np.testing.assert_array_equal(r0["mean"], r1["mean"])
    for h0, h1 in zip(r0["hist"], r1["hist"]):
        for k in ("reward_mean", "episodes", "value_loss",
                  "policy_loss", "reward_terms"):
            assert h0[k] == h1[k]
        assert all(np.all(np.isfinite(v)) for v in h0.values())


def test_rank0_checkpoint_runs_in_jax_and_the_port(ranks):
    """Rank 0's checkpoint (the single-process layout), read with plain
    pickle: its policy mean through JAX nets.policy_mcp_mean and through
    the port's policy_from_numpy equals the ranks' within 1e-5 (float32
    products in another order; the port's bit for bit)."""
    import pickle

    from uhc_tpu.learn import nets as JN
    from uhc_tpu_torch.learn import nets

    res, out = ranks
    run = res[0]["run"]
    with open(f"{out}/run/models/iter_0002.p", "rb") as f:
        ck = pickle.load(f)
    assert set(ck) >= {"policy_params", "value_params", "log_std",
                       "running_stats", "sampler", "epoch"}
    assert ck["epoch"] == 2
    close(JN.policy_mcp_mean(ck["policy_params"], jnp.asarray(run["probe"]),
                             "relu"), run["mean"], 1e-5)
    pol = nets.policy_from_numpy(ck["policy_params"], "relu", "cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(
            pol(torch.tensor(run["probe"])).numpy(), run["mean"])


def test_dryrun_multichip_two_ranks():
    """__graft_entry__.dryrun_multichip's twin on two CPU ranks: one full
    training step of 4 envs × 3 steps, finite stats."""
    from uhc_tpu_torch.learn import data_parallel as DP

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        stats = DP.dryrun_multichip(2, wait=SPAWN_S)
    assert stats["steps"] == 12
    assert np.isfinite(stats["reward_mean"])


def test_envs_must_split_over_the_ranks():
    """An env count the world size does not divide is refused."""
    from uhc_tpu_torch.learn.agent import CopycatAgent
    from uhc_tpu_torch.learn.data_parallel import Dist

    with pytest.raises(ValueError, match="do not split over 2 ranks"):
        CopycatAgent(R.agent_cfg(), R.GAIT, num_envs=5,
                     dist=Dist(0, 2, torch.device("cpu")))
