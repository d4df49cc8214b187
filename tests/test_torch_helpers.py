"""Shared set-up of the PyTorch-port parity tests (no tests here).

Both packages load the same stand-in humanoid files: the port with its own
MJCF loader, the JAX package with `uhc_tpu.smpl.mjcf.load_mjcf_humanoid`
on its numpy/scipy mesh path (the native mesh toolkit is switched off for
that one call, so both sides compute mass properties the same way).
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
    tt, tm = port_load(xml)
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
