"""The kin env (uhc_tpu_torch.envs.humanoid_kin) and the UHM rewards
(rewards/uhm_rewards.py) against the JAX package on the stand-in humanoid
and the gait clips: resets, step_ar and the AR observation; one
kin_env_step of 4 envs from the same states and actions with a seeded
copycat through each package's make_cc_policy_fn; every reward id on the
same post-step states; and a 3-step closed loop of a seeded kin net,
bounded by the JAX loop's own spread."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, few_threads, jax_kin_state, kin_setup

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

B = 4
QPOS_TOL, QVEL_TOL = 1e-5, 1e-3
# obs layout (4 + 3·74 wide before it): qvel's 75 entries
QVEL_BLOCK = slice(226, 301)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from uhc_tpu_torch.envs import humanoid_kin as K

    s = kin_setup(tmp_path_factory.mktemp("standin"))
    rng = np.random.default_rng(4)
    seq = rng.integers(0, len(s["keys"]), B)
    s["seq"] = seq
    s["state"] = K.kin_env_reset(s["tt"], s["m"], s["kc"], seq, s["lib"])
    # near the next GT frame: its height, root quat and pose, small root
    # velocities, and noise
    nxt = s["lib"]["qpos"][torch.as_tensor(seq), 1].numpy()
    act = np.concatenate([nxt[:, 2:], 0.3 * rng.standard_normal((B, 6))], 1)
    s["act"] = (act + 0.02 * rng.standard_normal(act.shape)).astype(
        np.float32)
    s["jstep"] = _jax_step_fn(s)
    return s


def _jax_step_fn(s):
    """JAX's batched kin_env_step, jitted once, with the copycat of
    make_cc_policy_fn on a normalization mean given at call time."""
    from uhc_tpu.envs import humanoid_kin as JK
    from uhc_tpu.learn import nets as JN

    rs = s["ck"]["running_stats"]
    pp = jax.tree.map(jnp.asarray, s["ck"]["policy_params"])
    std = jnp.sqrt(jnp.maximum(rs["m2"] / max(float(rs["n"]), 1.0), 1e-8))

    @jax.jit
    def step(st, a, mean):
        def cc(o):
            z = jnp.clip((o - mean) / std, -5.0, 5.0)
            return JN.policy_mcp_mean(pp, z[None], "relu")[0]

        return jax.vmap(lambda x, aa: JK.kin_env_step(
            s["jt"], s["jm"], s["jkc"], s["jcfg"].env, x, aa, s["jlib"], cc,
            s["jjpw"]))(st, a)

    return lambda st, a, dmean=0.0: step(st, jnp.asarray(a), jnp.asarray(
        rs["mean"]) + dmean)


def test_reset_step_ar_and_obs(setup):
    """kin_env_reset (every field), step_ar and get_ar_obs_v1 of B=4
    reset states against JAX: 1e-6 / 1e-6 / 1e-5."""
    from uhc_tpu.envs import humanoid_kin as JK
    from uhc_tpu_torch.envs import humanoid_kin as K

    s = setup
    js = jax.jit(jax.vmap(lambda q: JK.kin_env_reset(
        s["jt"], s["jm"], s["jkc"], jax.random.PRNGKey(0), q, s["jlib"])))(
        jnp.asarray(s["seq"], jnp.int32))
    for f in dataclasses.fields(K.KinEnvState):
        a, b = getattr(js, f.name), getattr(s["state"], f.name)
        if b is None:
            assert a is None, f.name
            continue
        close(np.asarray(a).astype(np.float64), b.numpy().astype(np.float64),
              1e-6)
    for pose_delta in (False, True):
        kc = dataclasses.replace(s["kc"], pose_delta=pose_delta)
        jkc = dataclasses.replace(s["jkc"], pose_delta=pose_delta)
        got = K.step_ar(kc, s["state"].qpos, torch.as_tensor(s["act"]))
        want = jax.vmap(lambda q, a: JK.step_ar(jkc, q, a))(
            js.qpos, jnp.asarray(s["act"]))
        close(np.asarray(want), got.numpy(), 1e-6)
    got = K.get_ar_obs_v1(s["tt"], s["m"], s["cfg"].env, s["state"],
                          s["lib"])
    want = jax.jit(jax.vmap(lambda st: JK.get_ar_obs_v1(
        s["jt"], s["jm"], s["jcfg"].env, st, s["jlib"])))(js)
    assert got.shape == (B, K.ar_obs_dim(s["tt"], s["cfg"].env)) == (B, 640)
    close(np.asarray(want), got.numpy(), 1e-5)


def test_kin_env_step_matches_jax(setup):
    """One hierarchical step: qpos within 1e-5, qvel within 1e-3 (the
    exact chain's bounds), the reward and each term within 1e-5, done and
    percent equal, the observation within 1e-5 but its qvel block (1e-3,
    the qvel bound); the copycat obs and action of both make_cc_policy_fn
    within 1e-5."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.envs.expert import qpos_fk_frame as jax_fk_frame
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.envs import humanoid_kin as K
    from uhc_tpu_torch.envs.expert import qpos_fk_frame

    s = setup
    st = s["state"]
    act = torch.as_tensor(s["act"])
    nxt = K.step_ar(s["kc"], st.qpos, act)
    cc_obs = H.get_obs(s["tt"], s["m"], s["cfg"].env, st, s["lib"],
                       tgt=qpos_fk_frame(s["tt"], s["m"], nxt))
    js = jax_kin_state(st)
    jobs = jax.jit(jax.vmap(lambda x, q: JH.get_obs(
        s["jt"], s["jm"], s["jcfg"].env, x, s["jlib"],
        tgt=jax_fk_frame(s["jt"], s["jm"], q))))(js,
                                                 jnp.asarray(nxt.numpy()))
    close(np.asarray(jobs), cc_obs.numpy(), 1e-5)
    with torch.no_grad():
        close(np.asarray(jax.vmap(s["jcc"])(jnp.asarray(cc_obs.numpy()))),
              s["cc"](cc_obs).numpy(), 1e-5)

        out = K.kin_env_step(s["tt"], s["m"], s["kc"], s["cfg"].env, st, act,
                             s["lib"], s["cc"], s["jpw"])
    jout = s["jstep"](js, s["act"])
    close(jout[0].qpos, out[0].qpos, QPOS_TOL)
    close(jout[0].qvel, out[0].qvel, QVEL_TOL)
    close(jout[0].target_qpos, out[0].target_qpos, 1e-6)
    np.testing.assert_array_equal(np.asarray(jout[4]), out[4].numpy())
    close(jout[0].percent, out[0].percent, 1e-7)
    close(jout[2], out[2], 1e-5)
    close(jout[3], out[3], 1e-5)
    obs_j, obs_t = np.asarray(jout[1]), out[1].numpy()
    close(obs_j[:, QVEL_BLOCK], obs_t[:, QVEL_BLOCK], QVEL_TOL)
    rest = np.ones(obs_t.shape[1], bool)
    rest[QVEL_BLOCK] = False
    close(obs_j[:, rest], obs_t[:, rest], 1e-5)
    s["post"] = out[0]


REWARD_IDS = ("dynamic_supervision_v1", "dynamic_supervision_v2",
              "dynamic_supervision_v3", "dynamic_supervision_v4",
              "dynamic_supervision_v5", "dynamic_supervision_v6",
              "constant", "forward_v1")


@pytest.mark.parametrize("reward_id", REWARD_IDS)
def test_uhm_reward_matches_jax(setup, reward_id):
    """Every registry entry on the same post-step states (B=4, one kin
    step from the clips' frame 0; cur_t 1, so the GT velocity terms read
    frames 0 and 1): reward and terms within 1e-5."""
    from uhc_tpu.rewards.uhm_rewards import get_uhm_reward_fn as jax_fn
    from uhc_tpu_torch.envs import humanoid_kin as K
    from uhc_tpu_torch.rewards.uhm_rewards import get_uhm_reward_fn

    s = setup
    if "post" not in s:
        with torch.no_grad():
            s["post"] = K.kin_env_step(
                s["tt"], s["m"], s["kc"], s["cfg"].env, s["state"],
                torch.as_tensor(s["act"]), s["lib"], s["cc"], s["jpw"])[0]
    st = s["post"]
    r, terms = get_uhm_reward_fn(reward_id)(s["tt"], s["m"], s["kc"],
                                            s["cfg"].env, st, s["lib"])
    if "jax_rewards" not in s:      # every id in one JAX program
        s["jax_rewards"] = jax.jit(jax.vmap(lambda x: {
            i: jax_fn(i)(s["jt"], s["jm"], s["jkc"], s["jcfg"].env, x,
                         s["jlib"]) for i in REWARD_IDS}))(jax_kin_state(st))
    jr, jterms = s["jax_rewards"][reward_id]
    assert terms.shape == np.asarray(jterms).shape
    assert r.shape == (B,)
    close(jr, r, 1e-5)
    close(jterms, terms, 1e-5)


def test_closed_loop_matches_jax(setup):
    """Three hierarchical steps of a seeded kin net (MLP (64, 32), GRU 32;
    JAX's kin_net_init carried over) acting on its own AR observations,
    4 envs from the same resets (its random actions end every episode by
    the third step, as in JAX). Bounds from the JAX loop's own
    sensitivity: with the copycat's normalization mean 1e-6 away, JAX
    moves by the printed spread; the port is held to five times it in
    qpos, qvel, obs and rewards (a floor of the exact chain's bounds)."""
    from uhc_tpu.envs import humanoid_kin as JK
    from uhc_tpu.learn import kin_net as JKN
    from uhc_tpu_torch.envs import humanoid_kin as K
    from uhc_tpu_torch.learn import kin_net as KN

    s = setup
    kw = dict(mlp_hsize=(64, 32), rnn_hdim=32, model_v=1, env_obs=True)
    jspecs = JKN.KinNetSpecs(**kw)
    jp = JKN.kin_net_init(jax.random.PRNGKey(5), s["jt"], jspecs)
    net = KN.kin_net_from_numpy(jax.tree.map(np.asarray, jp),
                                KN.KinNetSpecs(**kw), "cpu")
    obs_fn = jax.jit(jax.vmap(lambda x: JK.get_ar_obs_v1(
        s["jt"], s["jm"], s["jcfg"].env, x, s["jlib"])))
    act_fn = jax.jit(jax.vmap(lambda o, hh: JKN.kin_net_action(
        jp, jspecs, o, hh)))

    def jax_loop(dmean):
        st = jax_kin_state(s["state"])
        obs, h = obs_fn(st), jnp.zeros((B, 32))
        for _ in range(3):
            a, h = act_fn(obs, h)
            st, obs, r, _, done = s["jstep"](st, a, dmean)
        return [np.asarray(x) for x in (st.qpos, st.qvel, obs, r, done)]

    want, moved = jax_loop(0.0), jax_loop(1e-6)
    with torch.no_grad():
        st = s["state"]
        obs = K.get_ar_obs_v1(s["tt"], s["m"], s["cfg"].env, st, s["lib"])
        h = torch.zeros((B, 32))
        for _ in range(3):
            a, h = net(obs, h)
            st, obs, r, _, done = K.kin_env_step(
                s["tt"], s["m"], s["kc"], s["cfg"].env, st, a, s["lib"],
                s["cc"], s["jpw"])
    got = [st.qpos, st.qvel, obs, r]
    for name, w, mv, g, floor in zip(("qpos", "qvel", "obs", "reward"), want,
                                     moved, got, (QPOS_TOL, QVEL_TOL,
                                                  QVEL_TOL, 1e-5)):
        spread = np.abs(w - mv).max()
        err = np.abs(w - g.numpy()).max()
        print(f"closed loop {name}: JAX vs itself (mean + 1e-6) "
              f"{spread:.3e}, port vs JAX {err:.3e}")
        assert err <= max(5 * spread, floor), name
    np.testing.assert_array_equal(want[4], done.numpy())
