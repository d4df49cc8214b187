"""A model library with a batched leaf outside the per-env kernel's set
(`control_step.PE_MODEL_LEAVES`) through the batched env step: the port
runs it on its plain chain, as the JAX package runs its XLA chain
(uhc_tpu/envs/humanoid_im.py:888-904), and the two agree over three
steps. The library is the stand-in with body_mass and jkp stacked into
two rows; states and actions are made from a seed with numpy."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import (GAIT, batched_steps_both, close,
                                few_threads, jax_cfg, load_both)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

FRAMES = 20
STEPS = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The stand-in on both sides, the 2-row library of body_mass and
    jkp on each, and each package's expert library of the first two gait
    clips (FRAMES frames)."""
    from uhc_tpu.data.dataset import build_expert_library as jax_library
    from uhc_tpu.data.dataset import load_motion_file as jax_motion
    from uhc_tpu.physics.model import Model as JModel
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")
    lib_model = dataclasses.replace(
        m, body_mass=torch.stack([m.body_mass, 1.2 * m.body_mass]),
        jkp=torch.stack([m.jkp, 0.8 * m.jkp]))
    jlib_model = JModel(**{f.name: jnp.asarray(getattr(lib_model, f.name)
                                               .numpy())
                           for f in dataclasses.fields(lib_model)})
    two = dict(list(load_motion_file(GAIT).items())[:2])
    jtwo = dict(list(jax_motion(GAIT).items())[:2])
    lib, _ = build_expert_library(tt, m, two, max_len=FRAMES)
    jlib, _ = jax_library(jt, jm, jtwo, max_len=FRAMES)
    return dict(jt=jt, jm=jlib_model, jlib=jlib, tt=tt, m=lib_model,
                lib=lib)


def test_library_with_other_leaves_runs_plain_chain_like_jax(setup,
                                                            monkeypatch):
    """EnvConfig() with the library as `fused_model`: neither package
    builds a kernel (the port's step carries kernel None, under
    UHC_TPU_LANE=0 too; the JAX package calls neither kernel factory), and
    three batched steps of 4 envs over both rows agree at the rollout
    tests' bounds (tests/test_torch_train.py): obs 2e-4, rewards 5e-6,
    qpos 1e-3."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.physics import pallas_lane as JPL
    from uhc_tpu.physics import pallas_substep as JPS
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.config.config import EnvConfig
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics import solver as S

    s = setup
    cfg = EnvConfig()
    called = []
    monkeypatch.setattr(JPL, "make_fused_do_simulation_lane",
                        lambda *a, **k: called.append("lane"))
    monkeypatch.setattr(JPS, "make_fused_do_simulation",
                        lambda *a, **k: called.append("split"))
    JH.make_env_step_batched(s["jt"], jax_cfg(cfg), fused_model=s["jm"])
    assert called == []
    monkeypatch.setenv("UHC_TPU_LANE", "0")
    assert H.make_env_step_batched(s["tt"], cfg,
                                   fused_model=s["m"]).kernel is None
    monkeypatch.delenv("UHC_TPU_LANE")

    rng = np.random.default_rng(16)
    A = sum(S.action_dims(s["tt"], cfg))
    acts = 0.1 * rng.standard_normal((STEPS, 4, A))
    jpw, bdw = default_diff_weights()
    step, jout, tout = batched_steps_both(
        (s["jt"], s["jm"], s["jlib"]), (s["tt"], s["m"], s["lib"]), cfg,
        np.array([0, 1, 1, 0]), np.array([0, 3, 5, 2]), acts, jpw, bdw)
    assert step.kernel is None
    for (jst, jobs, jrew), (st, obs, rew) in zip(jout, tout):
        close(jobs, obs, 2e-4)
        close(jrew, rew, 5e-6)
        close(jst.qpos, st.qpos, 1e-3)
