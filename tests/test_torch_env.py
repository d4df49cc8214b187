"""PyTorch port vs the JAX package: expert library, obs v1, the
world_rfc_implicit reward, env_step, and the policy / value networks
carried across from a checkpoint."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import GAIT, close, env_cfgs, jax_cfg, load_both
from test_torch_helpers import few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "uhc_implicit", "models", "iter_best.p")
B = 6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from uhc_tpu.data.dataset import build_expert_library as jax_build
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")
    jlib, jkeys = jax_build(jt, jm, jax_load_motion(GAIT), max_len=30)
    lib, keys = build_expert_library(tt, m, load_motion_file(GAIT),
                                     max_len=30)
    assert keys == jkeys
    return jt, jm, jlib, tt, m, lib


def test_expert_library_matches_jax(setup):
    """Every per-frame feature within 1e-4 (finite-difference velocities
    divide float32 rounding by dt = 1/30 s)."""
    _, _, jlib, _, _, lib = setup
    assert set(jlib) == set(lib)
    for k in jlib:
        close(jlib[k], lib[k], 1e-4, 1e-5)


def _states(setup, seed):
    """The same env states on both sides: clip frames + seeded noise."""
    from uhc_tpu.envs.humanoid_im import EnvState as JState
    from uhc_tpu_torch.envs.humanoid_im import EnvState, get_body_quat

    jt, jm, jlib, tt, m, lib = setup
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 6, B)
    start = rng.integers(0, 10, B)
    cur = rng.integers(1, 15, B)
    fr = start + cur
    qpos = np.asarray(lib["qpos"][seq, fr], np.float32).copy()
    qpos[:, 7:] += 0.05 * rng.standard_normal((B, 69))
    qvel = (np.asarray(lib["qvel"][seq, fr])
            + 0.1 * rng.standard_normal((B, 75))).astype(np.float32)
    prev = np.asarray(lib["qpos"][seq, fr - 1], np.float32)
    t = torch.tensor
    pq = t(qpos)
    port = EnvState(
        qpos=pq, qvel=t(qvel), prev_qpos=t(prev), cur_t=t(cur),
        start_ind=t(start), seq_idx=t(seq),
        prev_bquat=get_body_quat(t(prev)),
        done=torch.zeros(B, dtype=torch.bool),
        fail=torch.zeros(B, dtype=torch.bool),
        end=torch.zeros(B, dtype=torch.bool), percent=torch.zeros(B))
    i32 = lambda x: jnp.asarray(x, jnp.int32)             # noqa: E731
    jst = JState(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
        prev_qpos=jnp.asarray(prev), cur_t=i32(cur), start_ind=i32(start),
        seq_idx=i32(seq),
        prev_bquat=jnp.asarray(port.prev_bquat.numpy()),
        done=jnp.zeros(B, bool), fail=jnp.zeros(B, bool),
        end=jnp.zeros(B, bool), percent=jnp.zeros(B),
        rng=jnp.zeros((B, 2), jnp.uint32))
    return jst, port


def test_obs_v1_and_reward_match_jax(setup):
    """obs_v1 (784 wide) within 1e-4 (angles and positions rebuilt from
    float32 FK, expressed in the root frame), world_rfc_implicit reward
    and its five terms within 1e-5."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.rewards.reward_function import world_rfc_implicit as jrew
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.rewards.reward_function import world_rfc_implicit

    jt, jm, jlib, tt, m, lib = setup
    cfg = env_cfgs()["plain_pd"]
    jcfg = jax_cfg(cfg)
    jst, port = _states(setup, 0)
    obs_j = jax.vmap(lambda s: JH.obs_v1(jt, jm, jcfg, s, jlib))(jst)
    obs_t = H.get_obs(tt, m, cfg, port, lib)
    assert obs_t.shape == (B, H.obs_dim(tt, cfg)) == (B, 784)
    close(obs_j, obs_t, 1e-4, 1e-5)

    jpw, bdw = default_diff_weights()
    aux_j = {"jpos_diffw": jnp.asarray(jpw), "body_diffw": jnp.asarray(bdw)}
    aux_t = {"jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    act = np.random.default_rng(1).standard_normal((B, 75)).astype(
        np.float32) * 0.1
    rj, tj = jax.vmap(lambda s, a: jrew(jt, jm, jcfg, s, a, jlib, aux_j))(
        jst, jnp.asarray(act))
    rt, tt_ = world_rfc_implicit(tt, m, cfg, port, torch.tensor(act), lib,
                                 aux_t)
    close(rj, rt, 1e-5)
    close(tj, tt_, 1e-5)


def test_env_step_matches_jax(setup):
    """One env_step (exact per-substep solves, obs, reward, termination)
    vs uhc_tpu.envs.humanoid_im.env_step: qpos ≤ 1e-4, qvel ≤ 1e-2
    (15 substeps of float32 Cholesky solves), obs ≤ 1e-2 (it holds qvel),
    reward ≤ 1e-4, identical done/fail flags."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.envs import humanoid_im as H

    jt, jm, jlib, tt, m, lib = setup
    cfg = env_cfgs()["plain_pd"]
    jcfg = jax_cfg(cfg)
    jst, port = _states(setup, 2)
    act = (0.02 * np.random.default_rng(3).standard_normal((B, 75))).astype(
        np.float32)
    jpw, bdw = default_diff_weights()
    step = jax.jit(jax.vmap(lambda s, a: JH.env_step(
        jt, jm, jcfg, s, a, jlib, jnp.asarray(jpw), jnp.asarray(bdw),
        train=False)))
    sj, oj, rj, _, dj = step(jst, jnp.asarray(act))
    st, ot, rt, _, dt = H.env_step(tt, m, cfg, port, torch.tensor(act), lib,
                                   torch.tensor(jpw), torch.tensor(bdw),
                                   train=False)
    close(sj.qpos, st.qpos, 1e-4)
    close(sj.qvel, st.qvel, 1e-2)
    close(oj, ot, 1e-2)
    close(rj, rt, 1e-4)
    assert np.array_equal(np.asarray(dj), dt.numpy())
    assert np.array_equal(np.asarray(sj.fail), st.fail.numpy())
    close(sj.percent, st.percent, 1e-6)


def test_policy_and_value_from_checkpoint_match_jax():
    """The checkpoint's MCP policy mean and value head, carried across by
    policy_from_numpy / value_from_numpy, on the same normalized obs:
    ≤ 1e-5 (float32 products of width 784-512-256, summed in another
    order)."""
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.learn import nets, running_norm as RN

    ck = joblib_compat.load(CKPT)
    rng = np.random.default_rng(4)
    obs = (np.asarray(ck["running_stats"]["mean"])
           + rng.standard_normal((B, 784))).astype(np.float32)
    rs_j = JRN.RunningStats(*(jnp.asarray(ck["running_stats"][k])
                              for k in ("n", "mean", "m2")))
    x_j = JRN.normalize(rs_j, jnp.asarray(obs))
    x_t = RN.normalize(RN.from_numpy(ck["running_stats"], "cpu"),
                       torch.tensor(obs))
    close(x_j, x_t, 1e-5, 1e-5)
    pol = nets.policy_from_numpy(ck["policy_params"], "relu", "cpu")
    close(JN.policy_mcp_mean(ck["policy_params"], x_j, "relu"),
          pol(torch.tensor(np.asarray(x_j))), 1e-5, 1e-4)
    val = nets.value_from_numpy(ck["value_params"], "relu", "cpu")
    close(JN.value_apply(ck["value_params"], x_j, "relu"),
          val(torch.tensor(np.asarray(x_j))), 1e-5, 1e-4)


def test_seeded_policy_has_checkpoint_shapes():
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.learn import nets

    ck = joblib_compat.load(CKPT)
    ref = nets.policy_from_numpy(ck["policy_params"], "relu", "cpu")
    gen = torch.Generator().manual_seed(0)
    pol = nets.policy_mcp_init(784, 75, (512, 256), (300, 200), 8, gen,
                               device="cpu")
    assert [p.shape for p in pol.parameters()] == [
        p.shape for p in ref.parameters()]
    gen2 = torch.Generator().manual_seed(0)
    pol2 = nets.policy_mcp_init(784, 75, (512, 256), (300, 200), 8, gen2,
                                device="cpu")
    x = torch.randn(3, 784)
    assert torch.equal(pol(x), pol2(x))
