"""Bigfoot (`env.bigfoot`, a YAML whose mujoco_model names "bigfoot"): the
enlarged-feet model transform against uhc_tpu.smpl.masterfoot.bigfoot_model,
the tree the agent builds with it (alone and under masterfoot) against the
JAX agent's model, and a CPU epoch of the agent on it."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from test_torch_helpers import GAIT, close, few_threads, jax_cfg, load_both

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

FEET = ("L_Ankle", "R_Ankle", "L_Toe", "R_Toe")


def _bigfoot_cfg(**env):
    """uhc_implicit from a config dict whose mujoco_model names bigfoot."""
    from uhc_tpu_torch.config.config import UHC_IMPLICIT, Config

    cfg = Config.from_dict("uhc_implicit_bigfoot", {
        **UHC_IMPLICIT, "mujoco_model": "humanoid_smpl_neutral_bigfoot"})
    assert cfg.env.bigfoot
    return dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, **env))


def test_bigfoot_model_matches_jax_exactly(tmp_path):
    """Both packages' bigfoot_model on the same stand-in leaves: every leaf
    equal bit for bit; the four foot bodies scaled (contact points and
    inertial offsets by 1.6, mass by 1.6³, inertia by 1.6⁵), every other
    body and leaf untouched."""
    from uhc_tpu.physics.model import Model as JModel
    from uhc_tpu.smpl.masterfoot import bigfoot_model as jax_bigfoot
    from uhc_tpu_torch.physics.model import Model
    from uhc_tpu_torch.smpl.masterfoot import bigfoot_model

    _, (topo, model) = load_both(tmp_path)
    jmodel = JModel(**{f.name: jnp.asarray(getattr(model, f.name))
                       for f in dataclasses.fields(JModel)})
    ours, theirs = bigfoot_model(topo, model), jax_bigfoot(topo, jmodel)
    feet = [topo.body_names.index(n) for n in FEET]
    rest = [i for i in range(topo.nbody) if i not in feet]
    for f in dataclasses.fields(Model):
        a, b = np.asarray(getattr(ours, f.name)), np.asarray(getattr(theirs,
                                                                     f.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        if f.name not in ("contact_point", "body_ipos", "body_mass",
                          "body_inertia"):
            assert np.array_equal(a, np.asarray(getattr(model, f.name)))
    s = np.float32(1.6)
    base = {k: np.asarray(getattr(model, k)) for k in (
        "contact_point", "body_ipos", "body_mass", "body_inertia")}
    assert np.array_equal(ours.body_mass[feet], base["body_mass"][feet]
                          * s ** 3)
    assert np.array_equal(ours.body_inertia[feet],
                          base["body_inertia"][feet] * s ** 5)
    assert np.array_equal(ours.contact_point[feet],
                          base["contact_point"][feet] * s)
    for k, v in base.items():
        assert np.array_equal(np.asarray(getattr(ours, k))[rest], v[rest])


@pytest.mark.parametrize("masterfoot", [False, True])
def test_robot_family_matches_jax_agent(tmp_path, monkeypatch, masterfoot):
    """robot_family under bigfoot (24 bodies) and bigfoot + masterfoot (48)
    gives the JAX agent's tree and model: every leaf within 1e-5 (the two
    packages load the stand-in's meshes with their own float32 code), the
    feet enlarged on both, and the same obs and action widths."""
    import uhc_tpu.learn.agent as JA
    import uhc_tpu.native.meshtools as native
    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn.agent import robot_family
    from uhc_tpu_torch.physics.model import Model
    from uhc_tpu_torch.smpl.fixture_humanoid import (load_fixture_humanoid,
                                                     write_fixture_humanoid)

    cfg = _bigfoot_cfg(masterfoot=masterfoot)
    t24, m24 = load_fixture_humanoid()
    topo, model, conv, _, _ = robot_family(t24, m24, cfg.env)
    assert topo.nbody == (48 if masterfoot else 24)
    assert (conv is not None) == masterfoot
    plain = robot_family(t24, m24, dataclasses.replace(cfg.env,
                                                       bigfoot=False))[1]
    ankle = topo.body_names.index("L_Ankle")
    close(model.body_mass[ankle], plain.body_mass[ankle] * 1.6 ** 3, 1e-6,
          1e-6)

    xml = write_fixture_humanoid(str(tmp_path / "standin"))
    # the JAX agent's reset pose file is not in the repository: a standing
    # 24-body pose (it does not enter the model)
    neutral = np.zeros(76, np.float32)
    neutral[2:4] = 0.9, 1.0
    monkeypatch.setattr(JA, "load_neutral", lambda: (
        jnp.asarray(neutral), jnp.zeros(75, jnp.float32)))
    monkeypatch.setattr(native, "_load", lambda: None)
    jcfg = JConfig(**{**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)},
                      "env": jax_cfg(cfg.env)})
    jagent = JA.CopycatAgent(jcfg, GAIT, num_envs=2, horizon=2, seed=0,
                             model_xml=xml, max_seq_len=4,
                             results_dir=str(tmp_path / "jax"))
    assert tuple(jagent.topo.body_names) == tuple(topo.body_names)
    assert tuple(jagent.topo.parents) == tuple(topo.parents)
    for f in dataclasses.fields(Model):
        close(np.asarray(getattr(jagent.model, f.name)),
              np.asarray(getattr(model, f.name)), 1e-5, 1e-5)
    assert (jagent.obs_dim, jagent.action_dim) == (
        H.obs_dim(topo, cfg.env), sum(H.action_dims(topo, cfg.env)))


def test_bigfoot_agent_epoch_on_cpu(tmp_path):
    """The agent on the bigfoot config (24 bodies, enlarged feet) for one
    CPU epoch of 4 envs × 2 steps: finite stats, the value loss falls, the
    simulated model is the bigfoot one."""
    from uhc_tpu_torch.learn.agent import CopycatAgent

    cfg = _bigfoot_cfg()
    agent = CopycatAgent(cfg, GAIT, num_envs=4, horizon=2, seed=1,
                         device="cpu", max_seq_len=8,
                         results_dir=str(tmp_path))
    assert agent.topo.nbody == 24 and agent.converter is None
    toe = agent.topo.body_names.index("R_Toe")
    plain = CopycatAgent(dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, bigfoot=False)), GAIT, num_envs=4, horizon=2, seed=1,
        device="cpu", max_seq_len=8, results_dir=str(tmp_path / "plain"))
    assert float(agent.sim_model.body_inertia[toe, 0]) > 10 * float(
        plain.sim_model.body_inertia[toe, 0])
    st = agent.optimize_policy(0)
    assert all(np.all(np.isfinite(v)) for v in st.values())
    assert st["value_loss"] < st["value_loss_before"]
