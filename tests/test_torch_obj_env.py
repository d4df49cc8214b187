"""Scene objects in the port's envs against the JAX package on the
stand-in humanoid: env_reset / env_step with a dynamic box
(`env_step(obj_model=)`, `env_reset(dynamic_obj=)`), and the kin env with
a dynamic box (tests/test_obj_dynamics.py:112-151). The physics pieces
and the played-back track: tests/test_torch_objects.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, few_threads, jax_kin_state
from test_torch_objects import QPOS_TOL, QVEL_TOL, obj_setup

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return obj_setup(tmp_path_factory.mktemp("standin"))


def test_env_reset_and_step_with_dynamic_object(setup):
    """env_reset(dynamic_obj=True) starts each env's box at the track's
    window-start pose at rest; env_step(obj_model=) of B=2 from there
    against JAX's env_step: qpos 1e-5, qvel 1e-3, the box's pose 1e-5 and
    velocity 1e-3, reward within 1e-5; without dynamic_obj obj_qvel is
    None, as in JAX."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.physics import objects as JO
    from uhc_tpu_torch.data.dataset import neutral_from_library
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics import objects as O

    s = setup
    spec = [{"kind": "box", "size": [0.15, 0.15, 0.15], "mass": 2.0}]
    jom, om = JO.make_obj_model(spec), O.make_obj_model(spec, "cpu")
    lib, jlib = s["lib"], s["jlib"]
    nq, nv = neutral_from_library(lib)
    seq, start = torch.tensor([0, 1]), torch.tensor([0, 3])
    env = s["cfg"].env
    st = H.env_reset(s["tt"], s["m"], env, seq, lib, nq, nv, start_ind=start,
                     train=False, dynamic_obj=True)
    np.testing.assert_array_equal(st.obj_qpos.numpy(),
                                  lib["obj_pose"][seq, start].numpy())
    assert torch.equal(st.obj_qvel, torch.zeros(2, 6))
    assert H.env_reset(s["tt"], s["m"], env, seq, lib, nq, nv,
                       start_ind=start, train=False).obj_qvel is None
    jst = jax.vmap(lambda k, q, t: JH.env_reset(
        s["jt"], s["jm"], s["jcfg"].env, k, q, jlib, jnp.asarray(nq.numpy()),
        jnp.asarray(nv.numpy()), start_ind=t, train=False, dynamic_obj=True))(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray([0, 1]),
        jnp.asarray([0, 3]))
    close(jst.obj_qpos, st.obj_qpos, 0.0)
    close(jst.obj_qvel, st.obj_qvel, 0.0)
    rng = np.random.default_rng(23)
    act = (0.05 * rng.standard_normal((2, 75))).astype(np.float32)
    # the box against the left thigh
    pushed = st.obj_qpos.clone()
    pushed[:, :3] = st.qpos[:, :3] + torch.tensor([0.0, 0.1, -0.2])
    st = dataclasses.replace(st, obj_qpos=pushed)
    jst = dataclasses.replace(jst, obj_qpos=jnp.asarray(pushed.numpy()))
    aux = dict(jpos_diffw=s["jpw"], body_diffw=s["jpw"][1:])
    out = H.env_step(s["tt"], s["m"], env, st, torch.as_tensor(act), lib,
                     aux["jpos_diffw"], aux["body_diffw"], train=False,
                     obj_model=om)
    jout = jax.jit(jax.vmap(lambda x, a: JH.env_step(
        s["jt"], s["jm"], s["jcfg"].env, x, a, jlib, s["jjpw"],
        s["jjpw"][1:], train=False, obj_model=jom)))(jst, jnp.asarray(act))
    close(jout[0].qpos, out[0].qpos, QPOS_TOL)
    close(jout[0].qvel, out[0].qvel, QVEL_TOL)
    close(jout[0].obj_qpos, out[0].obj_qpos, QPOS_TOL)
    close(jout[0].obj_qvel, out[0].obj_qvel, QVEL_TOL)
    close(jout[2], out[2], 1e-5)
    assert float((out[0].obj_qpos - pushed).abs().max()) > 1e-4


def test_kin_env_with_dynamic_object(setup):
    """kin_env_reset(dynamic_obj=True) and one kin_env_step(obj_model=) of
    B=2 with the box at the thigh against JAX: qpos 1e-5, qvel 1e-3, the
    box 1e-5 / 1e-3, reward 1e-5; then two more port steps stay finite
    (tests/test_obj_dynamics.py:112-151)."""
    from uhc_tpu.envs import humanoid_kin as JK
    from uhc_tpu.physics import objects as JO
    from uhc_tpu_torch.envs import humanoid_kin as K
    from uhc_tpu_torch.physics import objects as O

    s = setup
    spec = [{"kind": "box", "size": [0.15, 0.15, 0.15], "mass": 2.0}]
    jom, om = JO.make_obj_model(spec), O.make_obj_model(spec, "cpu")
    st = K.kin_env_reset(s["tt"], s["m"], s["kc"], [0, 1], s["lib"],
                         dynamic_obj=True)
    assert torch.equal(st.obj_qvel, torch.zeros(2, 6))
    pushed = st.obj_qpos.clone()
    pushed[:, :3] = st.qpos[:, :3] + torch.tensor([0.0, 0.1, -0.2])
    st = dataclasses.replace(st, obj_qpos=pushed)
    nxt = s["lib"]["qpos"][torch.tensor([0, 1]), 1]
    act = torch.cat([nxt[:, 2:], torch.zeros(2, 6)], 1)
    with torch.no_grad():
        out = K.kin_env_step(s["tt"], s["m"], s["kc"], s["cfg"].env, st, act,
                             s["lib"], s["cc"], s["jpw"], train=False,
                             obj_model=om)
    jout = jax.jit(jax.vmap(lambda x, a: JK.kin_env_step(
        s["jt"], s["jm"], s["jkc"], s["jcfg"].env, x, a, s["jlib"],
        s["jcc"], s["jjpw"], train=False, obj_model=jom)))(
        jax_kin_state(st), jnp.asarray(act.numpy()))
    close(jout[0].qpos, out[0].qpos, QPOS_TOL)
    close(jout[0].qvel, out[0].qvel, QVEL_TOL)
    close(jout[0].obj_qpos, out[0].obj_qpos, QPOS_TOL)
    close(jout[0].obj_qvel, out[0].obj_qvel, QVEL_TOL)
    close(jout[2], out[2], 1e-5)
    st = out[0]
    with torch.no_grad():
        for _ in range(2):
            st, obs, r, _, _ = K.kin_env_step(
                s["tt"], s["m"], s["kc"], s["cfg"].env, st, act, s["lib"],
                s["cc"], s["jpw"], train=False, obj_model=om)
    for x in (st.qpos, st.obj_qpos, st.obj_qvel, obs, r):
        assert torch.isfinite(x).all()
