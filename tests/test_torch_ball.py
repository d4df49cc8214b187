"""The ball-joint family (one quaternion per joint, direct torque control,
obs v2_quat; the `ball` config) against the JAX package, on the stand-in
humanoid with joint_kind="ball" on both sides: the rotation helpers, ball
forward kinematics, one torque substep, obs v2_quat, the ball pose
converters, vertex metrics on 99-wide qpos and one CPU epoch of the agent
(the 3-step rollouts are in tests/test_torch_ball_rollout.py)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, few_threads, jax_cfg, load_both

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

GAIT = "sample_data/gait_clips.pkl"
FRAMES = 20
# one torque substep against the JAX one: the bounds of
# tests/test_fused_split.py
QPOS_TOL, QVEL_TOL = 1e-5, 1e-3


def _ball_env(**kw):
    from uhc_tpu_torch.config.config import BALL, Config

    return dataclasses.replace(Config.from_dict("ball", BALL).env, **kw)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The stand-in as a ball-joint tree on both sides, with each side's
    expert library of the gait clips cut to FRAMES frames."""
    from uhc_tpu.data.dataset import build_expert_library as jax_library
    from uhc_tpu.data.dataset import load_motion_file as jax_motion
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    jtb = dataclasses.replace(jt, joint_kind="ball")
    ttb = dataclasses.replace(tt, joint_kind="ball")
    m = model_from_numpy(tm, "cpu")
    jlib, _ = jax_library(jtb, jm, jax_motion(GAIT), max_len=FRAMES)
    lib, _ = build_expert_library(ttb, m, load_motion_file(GAIT),
                                  max_len=FRAMES)
    return dict(jt=jt, jtb=jtb, jm=jm, jlib=jlib, tt=tt, ttb=ttb, m=m,
                lib=lib)


def test_rotation_helpers_match_jax(both):
    """mat_to_quat (every one of its four pivots), quat_from_axis_angle,
    multi_quat_norm_v2 and qvel_fd_ball (on the ball library's frames, at
    30 fps) against the JAX functions at 1e-6; the ball library's
    features within 1e-6 but the finite-difference velocities (1e-5:
    float32 differences of qpos over 1/30 s)."""
    import uhc_tpu.maths as JM
    import uhc_tpu_torch.maths as M

    rng = np.random.default_rng(0)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q[:4] = np.eye(4)                      # a rotation for each pivot
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.asarray(JM.quat_to_mat(jnp.asarray(q)))
    close(JM.mat_to_quat(jnp.asarray(R)), M.mat_to_quat(torch.tensor(R)),
          1e-6)
    axis = rng.standard_normal((64, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(-3.0, 3.0, 64).astype(np.float32)
    close(JM.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)),
          M.quat_from_axis_angle(torch.tensor(axis), torch.tensor(angle)),
          1e-6)
    nq = rng.standard_normal((8, 96)).astype(np.float32)
    close(JM.multi_quat_norm_v2(jnp.asarray(nq)),
          M.multi_quat_norm_v2(torch.tensor(nq)), 1e-6)
    qp = both["lib"]["qpos"]
    cur, nxt = qp[:, :-1].reshape(-1, 99), qp[:, 1:].reshape(-1, 99)
    close(JM.qvel_fd_ball(jnp.asarray(cur.numpy()), jnp.asarray(nxt.numpy()),
                          1 / 30), M.qvel_fd_ball(cur, nxt, 1 / 30), 1e-6)
    for k, v in both["lib"].items():
        close(both["jlib"][k], v, 1e-5 if k in ("qvel", "rangv", "bangvel")
              else 1e-6)


def test_ball_fk_matches_euler_and_jax(both):
    """One pose in both layouts gives the same world kinematics (xpos
    1e-5, body quaternions equal up to sign within 1e-5), and the ball FK
    equals the JAX one (positions, quaternions, dof axes, anchors 1e-6)."""
    from uhc_tpu.physics import engine as JE
    from uhc_tpu_torch.maths import quat_from_euler_zyx
    from uhc_tpu_torch.physics import engine as E

    s = both
    rng = np.random.default_rng(1)
    B = 16
    qe = np.zeros((B, 76), np.float32)
    qe[:, :3] = [0.1, -0.2, 0.9]
    root = rng.standard_normal((B, 4))
    qe[:, 3:7] = root / np.linalg.norm(root, axis=1, keepdims=True)
    qe[:, 7:] = 0.3 * rng.standard_normal((B, 69))
    jq = quat_from_euler_zyx(torch.tensor(qe[:, 7:]).reshape(B, 23, 3))
    qb = torch.cat([torch.tensor(qe[:, :7]), jq.reshape(B, -1)], 1)
    ke = E.fk(s["tt"], s["m"], torch.tensor(qe))
    kb = E.fk(s["ttb"], s["m"], qb)
    close(ke["xpos"], kb["xpos"], 1e-5)
    close(np.ones((B, 24)), (ke["xquat"] * kb["xquat"]).sum(-1).abs(), 1e-5)
    kj = jax.vmap(lambda q: JE.fk(s["jtb"], s["jm"], q))(
        jnp.asarray(qb.numpy()))
    for k in ("xpos", "xquat", "xipos", "axes", "anchors"):
        close(kj[k], kb[k], 1e-6)


def _ball_states(lib, rng, B, qvel_scale=0.3):
    """Ball clip frames, seeded joint rates and torques (B, 69)."""
    S, T = lib["qpos"].shape[:2]
    qpos = lib["qpos"][rng.integers(0, S, B), rng.integers(0, T, B)]
    qvel = (qvel_scale * rng.standard_normal((B, 75))).astype(np.float32)
    tau = (20.0 * rng.standard_normal((B, 69))).astype(np.float32)
    return qpos.numpy().copy(), qvel, tau


def test_substep_torque_matches_jax(both):
    """One substep under direct torques on 32 ball states vs
    uhc_tpu.physics.engine.substep_torque at qpos 1e-5 / qvel 1e-3. An
    env where JAX's own float32 and float64 substeps miss each other by
    those bounds sits on a contact switch; such envs are left out of the
    comparison and counted, at most 1 in 8. Ball joints have no range
    penalty, and the integrated joint quaternions stay unit."""
    from uhc_tpu.physics import engine as JE
    from uhc_tpu_torch.physics import engine as E

    s = both
    B = 32
    qpos, qvel, tau = _ball_states(s["lib"], np.random.default_rng(3), B)
    qa = np.zeros((B, 75), np.float32)

    def jax_step(model, dtype):
        fn = jax.jit(jax.vmap(lambda q, v, t, a: JE.substep_torque(
            s["jtb"], model, q, v, t, a)[:2]))
        q, v = fn(*(jnp.asarray(x.astype(dtype))
                    for x in (qpos, qvel, tau, qa)))
        return np.asarray(q, np.float64), np.asarray(v, np.float64)

    q32, v32 = jax_step(s["jm"], np.float32)
    with jax.enable_x64(True):
        q64, v64 = jax_step(jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)), s["jm"]),
            np.float64)
    edge = ((np.abs(q32 - q64).max(1) > QPOS_TOL)
            | (np.abs(v32 - v64).max(1) > QVEL_TOL))
    assert edge.sum() * 8 <= B
    pq, pv, ptau = E.substep_torque(s["ttb"], s["m"], torch.tensor(qpos),
                                    torch.tensor(qvel), torch.tensor(tau),
                                    torch.tensor(qa))
    close(q32[~edge], pq[~edge], QPOS_TOL)
    close(v32[~edge], pv[~edge], QVEL_TOL)
    assert torch.equal(ptau, torch.tensor(tau))
    close(np.ones((B, 23)), pq[:, 7:].reshape(B, 23, 4).norm(dim=-1), 1e-6)
    spring, damp = E.limit_qfrc(s["m"], torch.tensor(qpos),
                                torch.tensor(qvel))
    assert not spring.any() and not damp.any()


def _env_states(s, B, seed):
    """The same ball env states on both sides: clip frames, seeded noise
    on the joint quaternions and rates."""
    from uhc_tpu.envs.humanoid_im import EnvState as JState
    from uhc_tpu_torch.envs.humanoid_im import EnvState, get_body_quat

    lib = s["lib"]
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 6, B)
    start = rng.integers(0, 8, B)
    cur = rng.integers(1, 10, B)
    fr = start + cur
    qpos = np.asarray(lib["qpos"][seq, fr], np.float32).copy()
    qpos[:, 7:] += 0.05 * rng.standard_normal((B, 92))
    qvel = (np.asarray(lib["qvel"][seq, fr])
            + 0.1 * rng.standard_normal((B, 75))).astype(np.float32)
    prev = np.asarray(lib["qpos"][seq, fr - 1], np.float32)
    t = torch.tensor
    port = EnvState(
        qpos=t(qpos), qvel=t(qvel), prev_qpos=t(prev), cur_t=t(cur),
        start_ind=t(start), seq_idx=t(seq),
        prev_bquat=get_body_quat(t(prev)),
        done=torch.zeros(B, dtype=torch.bool),
        fail=torch.zeros(B, dtype=torch.bool),
        end=torch.zeros(B, dtype=torch.bool), percent=torch.zeros(B))
    i32 = lambda x: jnp.asarray(x, jnp.int32)             # noqa: E731
    jst = JState(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
        prev_qpos=jnp.asarray(prev), cur_t=i32(cur), start_ind=i32(start),
        seq_idx=i32(seq), prev_bquat=jnp.asarray(port.prev_bquat.numpy()),
        done=jnp.zeros(B, bool), fail=jnp.zeros(B, bool),
        end=jnp.zeros(B, bool), percent=jnp.zeros(B),
        rng=jnp.zeros((B, 2), jnp.uint32))
    return jst, port


def test_obs_v2_quat_matches_jax(both):
    """Obs v2 of the ball family (v2_quat, 517 wide) vs uhc_tpu get_obs
    within 1e-5; the prev_bquat of a ball qpos is its quaternions; obs v1
    of a ball tree stays obs v1, as in the JAX dispatch."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.envs import humanoid_im as H

    s = both
    jst, port = _env_states(s, 16, 1)
    cfg = _ball_env()
    oj = JH.get_obs_batched(s["jtb"], s["jm"], jax_cfg(cfg), jst, s["jlib"])
    ot = H.get_obs(s["ttb"], s["m"], cfg, port, s["lib"])
    assert ot.shape == (16, 517) == (16, H.obs_dim(s["ttb"], cfg))
    assert JH.obs_dim(s["jtb"], jax_cfg(cfg)) == 517
    close(oj, ot, 1e-5)
    close(jax.vmap(JH.get_body_quat)(jst.prev_qpos), port.prev_bquat, 0.0)
    v1 = dataclasses.replace(cfg, obs_v=1)
    assert H.obs_dim(s["ttb"], v1) == JH.obs_dim(s["jtb"], jax_cfg(v1))


def test_blown_up_env_fails_with_zero_reward(both):
    """Under torque control a light body can spin up until the state
    overflows (the ball config blows up envs within a few control steps
    of a fresh policy at 256 envs). Such an env fails, as in the JAX
    package, and earns zero reward and zero reward terms where the JAX
    package returns NaN; the other envs' rewards are unchanged; a NaN
    bootstrap of an episode that ended at the last step leaves the
    advantages as a zero one does."""
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn.gae import estimate_advantages

    s = both
    cfg = _ball_env()
    _, port = _env_states(s, 8, 2)
    act = torch.zeros(8, 69)
    jpw, bdw = (torch.tensor(w) for w in default_diff_weights())
    _, _, r0, t0, _ = H.env_post_step(s["ttb"], s["m"], cfg, port, act,
                                      s["lib"], jpw, bdw)
    qpos, qvel = port.qpos.clone(), port.qvel.clone()
    qpos[0, 9] = float("nan")
    qvel[1, 20] = 2e4
    blown = dataclasses.replace(port, qpos=qpos, qvel=qvel)
    st, _, r, t, done = H.env_post_step(s["ttb"], s["m"], cfg, blown, act,
                                        s["lib"], jpw, bdw)
    assert st.fail[:2].all() and done[:2].all()
    assert not r[:2].any() and not t[:2].any()
    assert torch.equal(r[2:], r0[2:]) and torch.equal(t[2:], t0[2:])
    rng = np.random.default_rng(3)
    rew, val = (torch.tensor(rng.standard_normal((4, 8)), dtype=torch.float32)
                for _ in range(2))
    masks = torch.ones(4, 8)
    masks[-1, :3] = 0.0
    boot = torch.tensor(rng.standard_normal(8), dtype=torch.float32)
    bad = boot.clone()
    bad[:3] = float("nan")
    zero = boot.clone()
    zero[:3] = 0.0
    for a, b in zip(estimate_advantages(rew, masks, val, bad, 0.95, 0.95),
                    estimate_advantages(rew, masks, val, zero, 0.95, 0.95)):
        assert torch.equal(a, b)


def test_ball_qpose_round_trips(both):
    """smpl_to_qpose_ball vs JAX at 1e-6; qpos_ball_to_smpl gives the
    pose back (angles under π, 1e-5) and equals JAX's at 1e-6; the ball
    and euler layouts of one clip agree through FK (1e-5)."""
    from uhc_tpu.smpl import convert as JC
    from uhc_tpu_torch.physics import engine as E
    from uhc_tpu_torch.smpl import convert as C

    s = both
    rng = np.random.default_rng(4)
    pose = (0.6 * rng.standard_normal((12, 72))).astype(np.float32)
    trans = rng.standard_normal((12, 3)).astype(np.float32)
    ro = s["m"].body_pos[0].numpy()
    qb = C.smpl_to_qpose_ball(pose, ro, trans)
    assert qb.shape == (12, 99)
    close(JC.smpl_to_qpose_ball(pose, ro, trans), qb, 1e-6)
    aa, tr = C.qpos_ball_to_smpl(qb, ro)
    close(pose.reshape(12, 24, 3), aa, 1e-5)
    close(trans, tr, 1e-6)
    jaa, jtr = JC.qpos_ball_to_smpl(jnp.asarray(qb.numpy()), ro)
    close(jaa, aa, 1e-6)
    close(jtr, tr, 1e-6)
    qe = C.smpl_to_qpose(pose, ro, trans)
    close(E.fk(s["tt"], s["m"], qe)["xpos"], E.fk(s["ttb"], s["m"],
                                                   qb)["xpos"], 1e-5)


def test_vertices_from_ball_qpos_match_jax():
    """vertices_from_qpos on 99-wide ball qpos (identity joints, and a
    seeded pose) vs the JAX function at 1e-5, and equal to the euler
    layout's vertices of the same pose."""
    from uhc_tpu.learn.metrics import vertices_from_qpos as jax_verts
    from uhc_tpu.smpl.lbs import synthetic_smpl_data as jax_synth
    from uhc_tpu_torch.learn.metrics import vertices_from_qpos
    from uhc_tpu_torch.smpl import convert as C
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data

    T = 3
    ident = np.zeros((T, 99), np.float32)
    ident[:, 2] = 0.92
    ident[:, 3] = 1.0
    ident[:, 7::4] = 1.0
    rng = np.random.default_rng(5)
    pose = (0.5 * rng.standard_normal((T, 72))).astype(np.float32)
    ro = np.array([0.0, 0.1, 0.9], np.float32)
    posed = C.smpl_to_qpose_ball(pose, ro).numpy()
    betas = (0.5 * rng.standard_normal(16)).astype(np.float32)
    sd, jsd = synthetic_smpl_data(), jax_synth()
    for qpos in (ident, posed):
        v = vertices_from_qpos(qpos, sd, betas, ro)
        assert v.shape == (T, 512, 3) and np.isfinite(v).all()
        close(jax_verts(qpos, jsd, betas, ro), v, 1e-5)
    euler = C.smpl_to_qpose(pose, ro).numpy()
    close(vertices_from_qpos(euler, sd, betas, ro),
          vertices_from_qpos(posed, sd, betas, ro), 1e-5)


def test_ball_agent_cpu_epoch(tmp_path):
    """One CPU epoch of CopycatAgent under the ball config (4 envs × 4
    steps): ball tree, 99-wide library and neutral pose (a clip frame, in
    quaternions), obs 517, action 69, finite stats, the value loss
    falling, no kernel on the torque route, the eval with its vertex
    metrics off (no model data) finite."""
    from uhc_tpu_torch.config.config import BALL, Config
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn.agent import CopycatAgent

    agent = CopycatAgent(Config.from_dict("ball", BALL), GAIT, num_envs=4,
                         horizon=4, max_seq_len=8, device="cpu",
                         results_dir=str(tmp_path))
    assert agent.topo.joint_kind == "ball"
    assert (agent.obs_dim, agent.action_dim) == (517, 69)
    assert agent.expert_lib["qpos"].shape[-1] == 99
    assert agent.aux["neutral_qpos"].shape == (99,)
    assert H.make_env_step_batched(agent.topo, agent.env_cfg,
                                   fused_model=agent.model).kernel is None
    st = agent.optimize_policy(0)
    assert all(np.all(np.isfinite(v)) for v in st.values())
    assert st["value_loss"] < st["value_loss_before"]
    res = agent.eval_policy(track_best=False)
    assert res["summary"]["num_seqs"] == 6
    assert all(np.isfinite(v) for v in res["summary"].values())
