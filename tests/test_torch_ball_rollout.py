"""A 3-step rollout of the ball-joint family (the `ball` config: direct
torques, obs v2_quat) against the JAX package, over a shared model and
over a shaped library, on the stand-in with joint_kind="ball" on both
sides (the set-up of tests/test_torch_ball.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_ball import FRAMES, _ball_env, both  # noqa: F401
from test_torch_helpers import close, few_threads, jax_cfg

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

SHAPE = "sample_data/shape_clips.pkl"

HORIZON = 3


@pytest.mark.parametrize("library", ["shared", "shaped"])
def test_ball_rollout_matches_jax(both, library):
    """Three steps of 8 envs under the ball config with a small Gaussian
    policy, the mean action, eval-mode resets, unit running stats and
    the torque route (exact substeps) on both sides, against
    uhc_tpu.learn.rollout, at the bounds of the uhc_implicit rollout test
    (tests/test_torch_train.py): obs 2e-4, bootstrap obs 4e-2, actions
    1e-4, rewards 5e-6, final qpos 1e-3. Once over the shared model, once
    over a shaped library of the 8 shape clips (has_shape: the 17-wide
    shape observation, each env on its own body)."""
    from uhc_tpu.data.dataset import build_shaped_library as jax_shaped
    from uhc_tpu.data.dataset import load_motion_file as jax_motion
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu.learn.rollout import make_rollout_fn as jax_rollout
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu.smpl.lbs import synthetic_smpl_data_like as jax_like
    from uhc_tpu_torch.data.dataset import (build_shaped_library,
                                            load_motion_file,
                                            neutral_from_library)
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.rollout import make_rollout_fn
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data_like

    s = both
    B = 8
    if library == "shaped":
        cfg = _ball_env(has_shape=True)
        jlib, _, jmodel = jax_shaped(
            s["jtb"], s["jm"], jax_motion(SHAPE), jax_like(s["jt"], s["jm"]),
            jax_cfg(cfg), max_len=FRAMES)
        lib, _, model = build_shaped_library(
            s["ttb"], s["m"], load_motion_file(SHAPE),
            synthetic_smpl_data_like(s["tt"], s["m"]), cfg, max_len=FRAMES)
        seq = np.arange(B)
    else:
        cfg = _ball_env()
        jlib, lib, jmodel, model = s["jlib"], s["lib"], s["jm"], s["m"]
        seq = np.arange(B) % 6
    D, A = H.obs_dim(s["ttb"], cfg), 69
    assert D == 517 + (17 if library == "shaped" else 0)
    pol = nets.policy_gaussian_init(D, A, (64, 32),
                                    torch.Generator().manual_seed(8),
                                    "relu", "cpu")
    jpw, bdw = default_diff_weights()
    nq, nv = neutral_from_library(lib)
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    aux_j = {"neutral_qpos": jnp.asarray(nq.numpy()),
             "neutral_qvel": jnp.zeros(75), "jpos_diffw": jnp.asarray(jpw),
             "body_diffw": jnp.asarray(bdw)}
    start = np.array([0, 4, 9, 2, 1, 5, 3, 7])
    jcfg = jax_cfg(cfg)
    fn = jax.jit(jax_rollout(
        s["jtb"], jcfg, lambda p, x: JN.policy_gaussian_mean(p, x, "relu"),
        HORIZON, fused_model=None))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jst = jax.vmap(lambda k, q, st: JH.env_reset(
        s["jtb"], jmodel, jcfg, k, q, jlib, aux_j["neutral_qpos"],
        aux_j["neutral_qvel"], start_ind=st, train=False))(
        keys, jnp.asarray(seq, jnp.int32), jnp.asarray(start, jnp.int32))
    rsj0 = JRN.RunningStats(jnp.asarray(2.0), jnp.zeros(D), jnp.ones(D))
    sj, rsj, trj, lastj = fn(jmodel, jlib, aux_j, nets.policy_to_numpy(pol),
                             jnp.full(A, -2.3), rsj0, jst,
                             jax.random.PRNGKey(1), 0.0, 1.0,
                             jnp.zeros(len(seq) if library == "shaped"
                                       else 6))
    st0 = H.env_reset(s["ttb"], model, cfg, torch.tensor(seq), lib, nq, nv,
                      start_ind=torch.tensor(start), train=False)
    rst0 = RN.RunningStats(torch.tensor(2.0), torch.zeros(D), torch.ones(D))
    st, rst, trt, lastt = make_rollout_fn(s["ttb"], cfg, pol, HORIZON)(
        model, lib, aux, torch.full((A,), -2.3), rst0, st0,
        torch.Generator().manual_seed(0), 0.0, 1.0,
        torch.zeros(lib["len"].shape[0]))
    assert st.qpos.shape == (B, 99)
    np.testing.assert_array_equal(np.asarray(trj.dones), trt.dones.numpy())
    np.testing.assert_array_equal(np.asarray(trj.masks), trt.masks.numpy())
    close(trj.states, trt.states, 2e-4)
    close(lastj, lastt, 4e-2)
    close(trj.actions, trt.actions, 1e-4)
    close(trj.rewards, trt.rewards, 5e-6)
    close(sj.qpos, st.qpos, 1e-3)
    assert float(rsj.n) == float(rst.n) == 2 + B * HORIZON
