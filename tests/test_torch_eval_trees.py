"""The eval CLI on the tree the config names: `run_eval` with
`masterfoot: true` (48 bodies) and with `robot_model: smplh` (52) against
uhc_tpu.learn.evaluate.make_eval_fn(..., fused_model=None) on the same
tree, built from the stand-in humanoid on both sides, with the bounds of
tests/test_torch_eval.py. No checkpoint exists at these widths, so both
sides run one seeded policy, written as a checkpoint in the JAX package's
layout, under unit normalization."""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_eval import FRAMES, QPOS_TOL
from test_torch_helpers import (BIG_FAMILIES, GAIT, big_env_cfg, big_trees,
                                close, few_threads, jax_cfg)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return big_trees(tmp_path_factory.mktemp("standin"))


@pytest.mark.parametrize("family", BIG_FAMILIES)
def test_eval_on_big_tree_matches_jax(trees, family, tmp_path):
    """The six gait clips over 7 closed-loop control steps on the big
    tree: predicted qpos and joint positions within QPOS_TOL, the first
    step within 2e-3, identical fail-safe flags and percent within 1e-6,
    as for the 24-body eval; pred_qpos is 148 (masterfoot) or 160
    (SMPL-H) wide."""
    from uhc_tpu.data.dataset import build_expert_library as jax_build
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu.learn.evaluate import make_eval_fn as jax_eval
    from uhc_tpu_torch.cli.eval import run_eval
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets

    (jt, jm, jc), (tt, _, _) = trees[family]
    cfg = dataclasses.replace(Config.uhc_implicit(),
                              env=big_env_cfg(family))
    obs_dim, act_dim = H.obs_dim(tt, cfg.env), sum(H.action_dims(tt,
                                                                 cfg.env))
    params = nets.policy_to_numpy(nets.make_policy(
        cfg, obs_dim, act_dim, torch.Generator().manual_seed(4), "cpu"))
    rs = {"n": np.float32(2.0), "mean": np.zeros(obs_dim, np.float32),
          "m2": np.ones(obs_dim, np.float32)}
    ckpt = str(tmp_path / "policy.p")
    with open(ckpt, "wb") as f:
        pickle.dump({"policy_params": params, "running_stats": rs}, f)

    res = run_eval(GAIT, ckpt, device="cpu", max_seq_len=FRAMES, cfg=cfg)
    traj_t = res["traj"]
    assert traj_t["pred_qpos"].shape == (6, FRAMES - 1, tt.nq)
    assert tt.nq == {"masterfoot": 148, "smplh": 160}[family]

    jlib, _ = jax_build(jt, jm, jax_load_motion(GAIT), max_len=FRAMES,
                        converter=jc,
                        base_root_offset=None if jc is None
                        else jm.body_pos[0])
    if jc is None:
        from uhc_tpu.smpl.smplh import smplh_diff_weights

        jpw, bdw = smplh_diff_weights()
    else:
        jpw = jc.get_new_diff_weight().astype(np.float32)
        bdw = jpw[1:]
    aux_j = {"neutral_qpos": jlib["qpos"][0, 0],
             "neutral_qvel": jnp.zeros(jt.nv),
             "jpos_diffw": jnp.asarray(jpw), "body_diffw": jnp.asarray(bdw)}
    fn_j = jax_eval(jt, jax_cfg(cfg.env),
                    lambda p, x: JN.policy_mcp_mean(p, x, "relu"),
                    FRAMES - 1, fused_model=None)
    traj_j, fs_j, pc_j = fn_j(jm, jlib, aux_j, params, JRN.RunningStats(
        *(jnp.asarray(rs[k]) for k in ("n", "mean", "m2"))))

    close(traj_j["pred_qpos"], traj_t["pred_qpos"], QPOS_TOL)
    close(traj_j["pred_jpos"], traj_t["pred_jpos"], QPOS_TOL)
    close(np.asarray(traj_j["pred_qpos"])[:, 0], traj_t["pred_qpos"][:, 0],
          2e-3)
    assert np.array_equal(np.asarray(fs_j), res["fail_safe"].numpy())
    close(pc_j, res["percent"], 1e-6)

