"""The slice as a whole: closed-loop evaluation of the checkpoint's policy
over the six gait clips through the port's eval function vs
uhc_tpu.learn.evaluate.make_eval_fn(..., fused_model=None), and the
port's eval CLI."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import GAIT, close, env_cfgs, jax_cfg, load_both
from test_torch_helpers import few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "uhc_implicit", "models", "iter_best.p")
FRAMES = 8          # 7 control steps per clip


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from uhc_tpu.data.dataset import build_expert_library as jax_build
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu.learn.evaluate import make_eval_fn as jax_eval
    from uhc_tpu.learn.evaluate import summarize as jax_summarize
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file,
                                            neutral_from_library)
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.evaluate import make_eval_fn, summarize
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    cfg = env_cfgs()["plain_pd"]
    ck = joblib_compat.load(CKPT)
    jpw, bdw = default_diff_weights()

    # JAX side: the XLA solver chain (pcg 5), scan over time
    jlib, keys = jax_build(jt, jm, jax_load_motion(GAIT), max_len=FRAMES)
    nq = jlib["qpos"][0, 0]
    aux_j = {"neutral_qpos": nq, "neutral_qvel": jnp.zeros(75),
             "jpos_diffw": jnp.asarray(jpw), "body_diffw": jnp.asarray(bdw)}
    rs_j = JRN.RunningStats(*(jnp.asarray(ck["running_stats"][k])
                              for k in ("n", "mean", "m2")))
    steps = int(jlib["len"].max()) - 1
    fn_j = jax_eval(jt, jax_cfg(cfg),
                    lambda p, x: JN.policy_mcp_mean(p, x, "relu"), steps,
                    fused_model=None)
    traj_j, fs_j, pc_j = fn_j(jm, jlib, aux_j, ck["policy_params"], rs_j)
    res_j = jax_summarize(traj_j, fs_j, pc_j, jlib, keys)
    # the reference against itself, normalization mean changed by 1e-6
    rs_p = JRN.RunningStats(rs_j.n, rs_j.mean * (1.0 + 1e-6), rs_j.m2)
    traj_p = fn_j(jm, jlib, aux_j, ck["policy_params"], rs_p)[0]

    # port: same weights, same solver schedule, Python loop over time
    m = model_from_numpy(tm, "cpu")
    lib, keys_t = build_expert_library(tt, m, load_motion_file(GAIT),
                                       max_len=FRAMES)
    nq_t, nv_t = neutral_from_library(lib)
    aux_t = {"neutral_qpos": nq_t, "neutral_qvel": nv_t,
             "jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    pol = nets.policy_from_numpy(ck["policy_params"], "relu", "cpu")
    fn_t = make_eval_fn(tt, cfg, pol, steps, fused_model=None)
    traj_t, fs_t, pc_t = fn_t(m, lib, aux_t,
                              RN.from_numpy(ck["running_stats"], "cpu"))
    res_t = summarize(traj_t, fs_t, pc_t, lib, keys_t)
    return (traj_j, fs_j, pc_j, res_j), (traj_t, fs_t, pc_t, res_t), traj_p


# The closed loop amplifies float32 rounding (contact switches, PCG with a
# stale preconditioner, the policy feeding state back): the JAX chain alone
# moves its predicted qpos by more than 5e-3 when its normalization mean
# changes by one part in 1e6 (test_reference_closed_loop_sensitivity prints
# the number). The port is held to bounds of that size.
QPOS_TOL = 2e-2


def test_reference_closed_loop_sensitivity(runs):
    (traj_j, _, _, _), (traj_t, _, _, _), traj_p = runs
    a, b = np.asarray(traj_j["pred_qpos"]), np.asarray(traj_p["pred_qpos"])
    self_gap = np.abs(a - b).max()
    port_gap = np.abs(a - traj_t["pred_qpos"].numpy()).max()
    print(f"closed-loop qpos: reference vs itself (mean*(1+1e-6)) "
          f"{self_gap:.3e}, port vs reference {port_gap:.3e}")
    assert self_gap > 5e-3


def test_eval_trajectories_match_jax(runs):
    """Predicted qpos and joint positions over 7 closed-loop control steps
    per clip within QPOS_TOL, identical fail-safe flags and percent; the
    first step, before any feedback, within 2e-3."""
    (traj_j, fs_j, pc_j, _), (traj_t, fs_t, pc_t, _), _ = runs
    assert traj_t["pred_qpos"].shape == tuple(traj_j["pred_qpos"].shape)
    close(traj_j["pred_qpos"], traj_t["pred_qpos"], QPOS_TOL)
    close(traj_j["pred_jpos"], traj_t["pred_jpos"], QPOS_TOL)
    close(np.asarray(traj_j["pred_qpos"])[:, 0], traj_t["pred_qpos"][:, 0],
          2e-3)
    assert np.array_equal(np.asarray(fs_j), fs_t.numpy())
    close(pc_j, pc_t, 1e-6)


def test_eval_metrics_match_jax(runs):
    """Per-sequence metrics (mm) within 1 mm + 2 % (see QPOS_TOL), success
    flags and coverage equal."""
    (_, _, _, res_j), (_, _, _, res_t), _ = runs
    assert list(res_j["per_seq"]) == list(res_t["per_seq"])
    for key, mj in res_j["per_seq"].items():
        mt = res_t["per_seq"][key]
        assert mj["succ"] == mt["succ"], key
        for k in ("mpjpe", "pa_mpjpe", "mpjpe_g", "root_dist", "vel_dist",
                  "accel_dist"):
            assert abs(mj[k] - mt[k]) <= 1.0 + 0.02 * abs(mj[k]), (
                key, k, mj[k], mt[k])
    assert res_j["summary"]["coverage"] == res_t["summary"]["coverage"]


def test_eval_cli_on_cpu(capsys):
    from uhc_tpu_torch.cli import eval as cli

    res = cli.main(["--device", "cpu", "--max-seq-len", "4", "--checkpoint",
                    CKPT])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("SUMMARY ")
    summary = json.loads(out[-1][len("SUMMARY "):])
    assert summary["num_seqs"] == 6 and np.isfinite(summary["mpjpe"])
    assert res["control_steps"] == 3
    assert tuple(res["traj"]["pred_qpos"].shape) == (6, 3, 76)


def test_cuda_entry_point_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from uhc_tpu_torch.cli.eval import run_eval

    with pytest.raises(RuntimeError, match="CUDA"):
        run_eval(GAIT, max_seq_len=3)
