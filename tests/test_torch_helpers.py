"""Shared set-up of the PyTorch-port parity tests (no tests here).

Both packages load the same stand-in humanoid files: the port with its own
MJCF loader, the JAX package with `uhc_tpu.smpl.mjcf.load_mjcf_humanoid`,
both on their numpy/scipy mesh path (the port's `native=False`, the JAX
package's native mesh toolkit switched off for that one call), the path
of the port's `load_fixture_humanoid`, so both sides compute mass
properties the same way.
Inputs are made from a seed with numpy and handed to both sides.
"""
import dataclasses

import numpy as np
import pytest
import torch

GAIT = "sample_data/gait_clips.pkl"


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads for torch while a module runs: the suite runs
    several test processes side by side, and small eager ops gain nothing
    from more threads but slow every process down when they oversubscribe
    the cores. JAX runs in float32, as tests/conftest.py sets it: a module
    fixture elsewhere that turns jax_enable_x64 on and then fails in its
    set-up leaves it on for every later module of the same test process."""
    import jax

    jax.config.update("jax_enable_x64", False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load_both(directory):
    """(jax (topo, model f32), port (topo, model numpy)) of the stand-in."""
    import jax.numpy as jnp

    import uhc_tpu.native.meshtools as native
    from uhc_tpu.physics.model import model_to_dtype
    from uhc_tpu.smpl.mjcf import load_mjcf_humanoid as jax_load
    from uhc_tpu_torch.smpl.fixture_humanoid import write_fixture_humanoid
    from uhc_tpu_torch.smpl.mjcf import load_mjcf_humanoid as port_load

    xml = write_fixture_humanoid(str(directory))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_load", lambda: None)
        jt, jm = jax_load(xml)
    tt, tm = port_load(xml, native=False)
    return (jt, model_to_dtype(jm, jnp.float32)), (tt, tm)


def states(lib_qpos, rng, B, qvel_scale=0.05):
    """Clip frames (qpos), seeded qvel noise and the next frames' joints —
    the state recipe of tests/test_fused_split.py, over clip frames, on
    any tree (qvel is one narrower than qpos)."""
    S, T = lib_qpos.shape[:2]
    nv = lib_qpos.shape[-1] - 1
    si = rng.integers(0, S, B)
    ti = rng.integers(0, T - 1, B)
    qpos = np.asarray(lib_qpos[si, ti], np.float32)
    qvel = (qvel_scale * rng.standard_normal((B, nv))).astype(np.float32)
    tb = np.asarray(lib_qpos[si, ti + 1, 7:], np.float32)
    return qpos, qvel, tb


def random_states(rng, B, nq=76):
    """Standing-height states with large random joint angles and rates:
    many ground contacts, some self-collisions and joint-limit hits (the
    24-body humanoid's widths by default)."""
    qpos = np.zeros((B, nq), np.float32)
    qpos[:, :2] = rng.standard_normal((B, 2))
    qpos[:, 2] = 0.9
    q = np.array([0.7071, 0.7071, 0.0, 0.0]) + 0.1 * rng.standard_normal(
        (B, 4))
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 7:] = 0.8 * rng.standard_normal((B, nq - 7))
    qvel = (0.5 * rng.standard_normal((B, nq - 1))).astype(np.float32)
    return qpos, qvel


def close(a, b, atol, rtol=0.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().cpu().numpy() if isinstance(b, torch.Tensor)
                   else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b) - rtol * np.abs(a)
    assert np.all(err <= atol), f"max excess {err.max()} over atol {atol}"


def env_cfgs():
    """The uhc_implicit env (plain PD) and its meta-PD variant."""
    from uhc_tpu_torch.config.config import Config

    env = Config.uhc_implicit().env
    return {"plain_pd": env,
            "meta_pd": dataclasses.replace(env, meta_pd=True)}


def jax_cfg(port_env_cfg):
    """The JAX EnvConfig with the same field values."""
    from uhc_tpu.config.config import EnvConfig

    return EnvConfig(**dataclasses.asdict(port_env_cfg))


BIG_FAMILIES = ("smplh", "masterfoot")


def big_trees(directory):
    """Both packages' big trees built from the stand-in:
    {family: ((jax topo, model f32, converter), (port topo, model numpy,
    converter))}. SMPL-H has no converter (None)."""
    import jax.numpy as jnp

    from uhc_tpu.physics.model import model_to_dtype
    from uhc_tpu.smpl.masterfoot import masterfoot_model as jax_mf
    from uhc_tpu.smpl.smplh import smplh_model as jax_smplh
    from uhc_tpu.smpl.smplh import smplh_topology as jax_smplh_topo
    from uhc_tpu_torch.smpl.masterfoot import masterfoot_model
    from uhc_tpu_torch.smpl.smplh import smplh_model, smplh_topology

    (jt, jm), (tt, tm) = load_both(directory)
    jmt, jmm, jconv = jax_mf(jt, jm)
    tmt, tmm, tconv = masterfoot_model(tt, tm)
    return {
        "smplh": ((jax_smplh_topo(),
                   model_to_dtype(jax_smplh(jt, jm), jnp.float32), None),
                  (smplh_topology(), smplh_model(tt, tm), None)),
        "masterfoot": ((jmt, model_to_dtype(jmm, jnp.float32), jconv),
                       (tmt, tmm, tconv)),
    }


def big_env_cfg(family, meta_pd=False):
    """uhc_implicit's env on a big tree (the port's EnvConfig)."""
    from uhc_tpu_torch.config.config import Config

    return dataclasses.replace(Config.uhc_implicit().env,
                               robot_model=("smplh" if family == "smplh"
                                            else "smpl"),
                               masterfoot=family == "masterfoot",
                               meta_pd=meta_pd)


def chain_tree(nb):
    """A chain of `nb` bodies (names b0.., no SMPL name, so no
    self-collision pair) with the stand-in's body and dof rows repeated:
    (Topology, Model of numpy arrays), a tree no robot family has, for
    routing checks on tree sizes."""
    from uhc_tpu_torch.physics.model import Model, Topology
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    t24, m = load_fixture_humanoid()
    topo = Topology(nb, tuple([-1] + list(range(nb - 1))),
                    tuple(f"b{i}" for i in range(nb)))
    body = np.arange(nb) % t24.nbody
    dof = np.arange(topo.ndof) % t24.ndof
    arm = np.asarray(m.armature)
    rows = {f: np.asarray(getattr(m, f))[body] for f in (
        "body_pos", "body_ipos", "body_mass", "body_inertia", "body_iquat",
        "contact_point", "contact_mask", "sc_point", "sc_radius")}
    rows.update({f: np.asarray(getattr(m, f))[dof] for f in (
        "jkp", "jkd", "torque_lim", "a_scale", "jnt_range")})
    return topo, dataclasses.replace(
        m, **rows, armature=np.concatenate([arm[:6], arm[6:][dof]]))


def batched_steps_both(jax_tree, port_tree, cfg, seq, start, actions,
                       jpos_diffw, body_diffw, jax_fused=True):
    """Both packages' batched env steps (`make_env_step_batched` with the
    model, or model library, as `fused_model`) from the same eval-mode
    resets of sequences `seq` at frames `start`, fed the seeded `actions`
    (T, B, A) one step each. `jax_tree` / `port_tree` are (topo, model,
    expert library) of each package; with `jax_fused` False the JAX
    step is built without `fused_model` (its XLA chain, the model given
    at step time). Returns
    (port step, [(JAX state, obs, reward)], [(port state, obs, reward)])
    per step."""
    import jax
    import jax.numpy as jnp

    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.data.dataset import neutral_from_library
    from uhc_tpu_torch.envs import humanoid_im as H

    jt, jm, jlib = jax_tree
    tt, m, lib = port_tree
    jcfg = jax_cfg(cfg)
    nq, nv = neutral_from_library(lib)
    B = len(seq)
    jst = jax.vmap(lambda k, q, st: JH.env_reset(
        jt, jm, jcfg, k, q, jlib, jnp.asarray(nq.numpy()),
        jnp.asarray(nv.numpy()), start_ind=st, train=False))(
        jax.random.split(jax.random.PRNGKey(0), B),
        jnp.asarray(seq, jnp.int32), jnp.asarray(start, jnp.int32))
    st = H.env_reset(tt, m, cfg, torch.tensor(seq), lib, nq, nv,
                     start_ind=torch.tensor(start), train=False)
    jstep = jax.jit(JH.make_env_step_batched(
        jt, jcfg, fused_model=jm if jax_fused else None),
        static_argnames="train")
    step = H.make_env_step_batched(tt, cfg, fused_model=m)
    jw, bw = np.asarray(jpos_diffw, np.float32), np.asarray(body_diffw,
                                                            np.float32)
    jout, tout = [], []
    for a in np.asarray(actions, np.float32):
        jst, jobs, jrew, _, _ = jstep(jm, jst, jnp.asarray(a), jlib,
                                      jnp.asarray(jw), jnp.asarray(bw),
                                      train=False)
        st, obs, rew, _, _ = step(m, st, torch.tensor(a), lib,
                                  torch.tensor(jw), torch.tensor(bw),
                                  train=False)
        jout.append((jst, jobs, jrew))
        tout.append((st, obs, rew))
    return step, jout, tout


def jax_library(lib):
    """The port's expert library as JAX arrays (the JAX package builds the
    same one, tests/test_torch_env.py; this skips its slower build)."""
    import jax.numpy as jnp

    return {k: jnp.asarray(v.numpy()) for k, v in lib.items()}


def kin_setup(directory, frames=12, seqs=None):
    """The kin stack's set-up on both sides: the stand-in, the gait clips'
    first `frames` frames (with `seqs`, those motion dicts instead), the
    uhm_1 config, each package's KinConfig, a seeded small MCP copycat
    (784 → (64, 32) × 3 primitives → 75) with running statistics as a
    checkpoint dict, each package's make_cc_policy_fn of it, and the diff
    weights."""
    import jax.numpy as jnp

    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu.envs import humanoid_kin as JK
    from uhc_tpu.learn.agent_uhm import make_cc_policy_fn as jax_cc
    from uhc_tpu_torch.config.config import UHM_1, Config
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.agent_uhm import kin_config, make_cc_policy_fn
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.constants import default_diff_weights

    (jt, jm), (tt, tm) = load_both(directory)
    m = model_from_numpy(tm, "cpu")
    lib, keys = build_expert_library(
        tt, m, load_motion_file(GAIT) if seqs is None else seqs,
        max_len=frames)
    cfg = Config.preset("uhm_1")
    jcfg = JConfig.from_dict("uhm_1", UHM_1)
    kc = kin_config(cfg)
    jkc = JK.KinConfig(**dataclasses.asdict(kc))
    rng = np.random.default_rng(11)
    pol = nets.policy_mcp_init(784, 75, (64, 32), (16, 8), 3,
                               torch.Generator().manual_seed(12), "relu",
                               "cpu")
    ck = {"policy_params": nets.policy_to_numpy(pol),
          "running_stats": {
              "n": np.float32(50.0),
              "mean": (0.1 * rng.standard_normal(784)).astype(np.float32),
              "m2": (50 * (0.5 + rng.random(784))).astype(np.float32)}}
    jpw, _ = default_diff_weights()
    return dict(jt=jt, jm=jm, tt=tt, m=m, lib=lib, jlib=jax_library(lib),
                keys=keys, cfg=cfg, jcfg=jcfg, kc=kc, jkc=jkc, ck=ck,
                cc=make_cc_policy_fn(ck, cfg, "cpu"),
                jcc=jax_cc(ck, jcfg, 784, 75),
                jpw=torch.as_tensor(jpw), jjpw=jnp.asarray(jpw))


def jax_kin_state(st):
    """A port KinEnvState as the JAX package's (B-leading pytree)."""
    import jax
    import jax.numpy as jnp

    from uhc_tpu.envs import humanoid_kin as JK

    def j(x):
        if x is None:
            return None
        x = x.detach().numpy()
        return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)

    B = st.qpos.shape[0]
    return JK.KinEnvState(**{f.name: j(getattr(st, f.name))
                             for f in dataclasses.fields(st)},
                          rng=jax.random.split(jax.random.PRNGKey(0), B))
