"""The obs and reward families, each against its JAX function: obs v0,
v3 (stacked v2), v4 (the transformer actor's token layout), v5 and v6 and
their widths; the rewards world_rfc_implicit_v1_mul, local_rfc_implicit,
local_rfc_explicit, world_rfc_implicit_v2 and _v3 with their terms. Three
gait clips cut to 12 frames, B = 6 states from clip frames plus seeded
noise, fed to both packages."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (GAIT, close, env_cfgs, few_threads,
                                jax_cfg, load_both)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

B, FRAMES, SEQS = 6, 12, 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from uhc_tpu.data.dataset import build_expert_library as jax_build
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")

    def first(seqs):
        return dict(list(seqs.items())[:SEQS])

    jlib, jkeys = jax_build(jt, jm, first(jax_load_motion(GAIT)),
                            max_len=FRAMES)
    lib, keys = build_expert_library(tt, m, first(load_motion_file(GAIT)),
                                     max_len=FRAMES)
    assert keys == jkeys
    return jt, jm, jlib, tt, m, lib


def _states(setup, seed):
    """The same env states on both sides: clip frames + seeded noise."""
    from uhc_tpu.envs.humanoid_im import EnvState as JState
    from uhc_tpu_torch.envs.humanoid_im import EnvState, get_body_quat

    lib = setup[5]
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, SEQS, B)
    start = rng.integers(0, 3, B)
    cur = rng.integers(1, 7, B)
    fr = start + cur
    qpos = np.asarray(lib["qpos"][seq, fr], np.float32).copy()
    qpos[:, 7:] += 0.05 * rng.standard_normal((B, 69))
    qvel = (np.asarray(lib["qvel"][seq, fr])
            + 0.1 * rng.standard_normal((B, 75))).astype(np.float32)
    prev = np.asarray(lib["qpos"][seq, fr - 1], np.float32).copy()
    prev[:, 7:] += 0.02 * rng.standard_normal((B, 69))
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
        seq_idx=i32(seq),
        prev_bquat=jnp.asarray(port.prev_bquat.numpy()),
        done=jnp.zeros(B, bool), fail=jnp.zeros(B, bool),
        end=jnp.zeros(B, bool), percent=jnp.zeros(B),
        rng=jnp.zeros((B, 2), jnp.uint32))
    return jst, port


# obs family -> (EnvConfig fields over uhc_implicit's env, width on the
# 24-body tree)
OBS = {
    "v0": (dict(obs_v=0), 74 + 75 + 69),
    "v0_heading_phase": (dict(obs_v=0, obs_heading=True, obs_phase=True,
                              root_deheading=True), 1 + 74 + 75 + 69 + 1),
    "v3": (dict(obs_v=3), 10 * 640),
    "v3_short": (dict(obs_v=3, fut_frames=3, obs_skip=4), 3 * 640),
    "v4": (dict(obs_v=4), 28 + 23 * 26),
    "v5": (dict(obs_v=5), 636),
    "v6": (dict(obs_v=6), 3 + 1 + 4 + 75 + 48 + 69 + 184),
    "v6_root_vel": (dict(obs_v=6, obs_vel="root"), 3 + 1 + 4 + 6 + 48 + 69
                    + 184),
}


@pytest.mark.parametrize("family", sorted(OBS))
def test_obs_family_matches_jax(setup, family):
    """get_obs against the JAX get_obs_batched, within 1e-4 absolute and
    1e-5 relative (angles and positions rebuilt from float32 FK, in the
    root or heading frame, as the obs v1 test), and obs_dim against the
    JAX obs_dim and the width the reference layout gives."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.envs import humanoid_im as H

    jt, jm, jlib, tt, m, lib = setup
    fields, width = OBS[family]
    cfg = dataclasses.replace(env_cfgs()["plain_pd"], **fields)
    jcfg = jax_cfg(cfg)
    jst, port = _states(setup, 0)
    want = JH.get_obs_batched(jt, jm, jcfg, jst, jlib)
    got = H.get_obs(tt, m, cfg, port, lib)
    assert H.obs_dim(tt, cfg) == JH.obs_dim(jt, jcfg) == width
    assert got.shape == (B, width) == want.shape
    close(want, got, 1e-4, 1e-5)


def test_obs_v4_tokens_are_the_local_rows(setup):
    """v4's last 23 × 26 features are the non-root bodies' rows (the
    transformer actor's tokens): the first three columns of row j are
    the target qpos of joint j (tests/test_inventory_r2.py:20-24)."""
    from uhc_tpu_torch.envs import humanoid_im as H

    _, _, _, tt, m, lib = setup
    cfg = dataclasses.replace(env_cfgs()["plain_pd"], obs_v=4)
    _, port = _states(setup, 1)
    obs = H.get_obs(tt, m, cfg, port, lib)
    tokens = obs[:, 28:].reshape(B, 23, 26)
    tgt = H.expert_at(lib, port.seq_idx,
                      port.start_ind + port.cur_t + 1)["qpos"]
    assert torch.equal(tokens[:, :, :3], tgt[:, 7:].reshape(B, 23, 3))


def test_ball_obs_still_refused(setup):
    """The ball flag changes obs v2 alone (v2_quat, held against JAX in
    tests/test_torch_ball.py): under obs v1 it dispatches as the JAX
    get_obs does, to obs v1, and the widths agree with JAX's obs_dim."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.envs import humanoid_im as H

    _, _, _, tt, m, lib = setup
    cfg = dataclasses.replace(env_cfgs()["plain_pd"], robot_ball=True)
    _, port = _states(setup, 0)
    plain = dataclasses.replace(cfg, robot_ball=False)
    assert torch.equal(H.get_obs(tt, m, cfg, port, lib),
                       H.get_obs(tt, m, plain, port, lib))
    ball = dataclasses.replace(tt, joint_kind="ball")
    for v in (1, 2):
        c = dataclasses.replace(cfg, obs_v=v)
        assert H.obs_dim(ball, c) == JH.obs_dim(ball, jax_cfg(c))
    assert H.obs_dim(ball, dataclasses.replace(cfg, obs_v=2)) == 517


def _reward_cfgs():
    from uhc_tpu_torch.config.config import EXPLICIT, Config

    env = env_cfgs()["plain_pd"]
    explicit = Config.from_dict("explicit", EXPLICIT).env
    jw = tuple(float(x) for x in np.linspace(0.5, 1.5, 24))
    return {
        "world_rfc_implicit_v1_mul": (env, 5),
        "world_rfc_implicit_v1_mul_vf": (
            dataclasses.replace(env, w_vf=0.1), 5),
        "local_rfc_implicit": (dataclasses.replace(
            env, extra_rw=(("w_v", 0.1), ("k_v", 0.01))), 6),
        "local_rfc_explicit": (explicit, 7),
        "world_rfc_implicit_v2": (env, 6),
        "world_rfc_implicit_v2_jpos_diffw": (dataclasses.replace(
            env, extra_rw=(("jpos_diffw", jw),)), 6),
        "world_rfc_implicit_v3": (dataclasses.replace(
            env, extra_rw=(("w_c", 50.0), ("k_j", 80.0))), 6),
    }


REWARD_CASES = sorted(_reward_cfgs())


@pytest.mark.parametrize("case", REWARD_CASES)
def test_reward_matches_jax(setup, case):
    """Each reward and its terms against the JAX function through its
    registry id, at float32 rounding: 1e-5 absolute and relative (v3's
    unnormalized sum reaches ~200, hence the relative part)."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.rewards.reward_function import get_reward_fn as jget
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.rewards.reward_function import get_reward_fn

    jt, jm, jlib, tt, m, lib = setup
    cfg, n_terms = _reward_cfgs()[case]
    rid = next(r for r in ("world_rfc_implicit_v1_mul", "local_rfc_implicit",
                           "local_rfc_explicit", "world_rfc_implicit_v2",
                           "world_rfc_implicit_v3") if case.startswith(r))
    cfg = dataclasses.replace(cfg, reward_id=rid)
    jcfg = jax_cfg(cfg)
    jst, port = _states(setup, 2)
    jpw, bdw = default_diff_weights()
    aux_j = {"jpos_diffw": jnp.asarray(jpw), "body_diffw": jnp.asarray(bdw)}
    aux_t = {"jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    A = sum(H.action_dims(tt, cfg))
    assert A == sum(JH.action_dims(jt, jcfg))
    act = (0.1 * np.random.default_rng(3).standard_normal((B, A))).astype(
        np.float32)
    fn_j = jget(rid)
    rj, tj = jax.vmap(lambda s, a: fn_j(jt, jm, jcfg, s, a, jlib, aux_j))(
        jst, jnp.asarray(act))
    rt, tt_ = get_reward_fn(rid)(tt, m, cfg, port, torch.tensor(act), lib,
                                 aux_t)
    assert tt_.shape == (B, n_terms) == tj.shape
    close(rj, rt, 1e-5, 1e-5)
    close(tj, tt_, 1e-5, 1e-5)
    # some terms are not saturated at 0 or 1
    assert bool(((tt_ > 0.01) & (tt_ < 0.99)).any())
