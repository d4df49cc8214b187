"""Scene objects in the port (physics/objects.py, the object terms of
engine.assemble / engine.substep, do_simulation(obj=), the env's object
state and the library's obj_pose track) against the JAX package on the
stand-in humanoid: the ground terms, the humanoid-object contacts and the
free-body substep on seeded states; one exact control step with a box
and a sphere; box and sphere drops that settle and the equal-and-opposite
contact wrench (the checks of tests/test_obj_dynamics.py); the track
played back by env_step and the batched step (tests/test_obj_scene.py).
The envs with a dynamic box: tests/test_torch_obj_env.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, few_threads, kin_setup

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

GAIT = "sample_data/gait_clips.pkl"
QPOS_TOL, QVEL_TOL = 1e-5, 1e-3
T = 12
SPECS = [{"kind": "box", "size": [0.15, 0.12, 0.1], "mass": 2.0},
         {"kind": "sphere", "size": 0.1, "mass": 1.0}]


def _track(T, x0=0.5, x1=1.5, z=0.25):
    """One object sliding along +x (free-joint qpos x y z qw qx qy qz)."""
    obj = np.zeros((T, 7), np.float32)
    obj[:, 0] = np.linspace(x0, x1, T)
    obj[:, 2] = z
    obj[:, 3] = 1.0
    return obj


def obj_setup(directory):
    """kin_setup over the gait clips with the first three carrying a
    sliding box's track."""
    from uhc_tpu_torch.data.dataset import load_motion_file

    seqs = load_motion_file(GAIT)
    for k in list(seqs)[:3]:
        seqs[k]["obj_pose"] = _track(len(np.asarray(seqs[k]["pose_aa"])))
    s = kin_setup(directory, frames=T, seqs=seqs)
    s["seqs"] = seqs
    return s


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return obj_setup(tmp_path_factory.mktemp("standin"))


def _models():
    from uhc_tpu.physics import objects as JO
    from uhc_tpu_torch.physics import objects as O

    return JO.make_obj_model(SPECS), O.make_obj_model(SPECS, "cpu")


def _near_body(s, B, rng):
    """B humanoid states from the clips and object poses at the pelvis and
    the left thigh, so that SC spheres penetrate both, with seeded
    velocities."""
    from uhc_tpu_torch.physics import engine as E

    qpos = s["lib"]["qpos"][torch.arange(B) % 6, rng.integers(0, T, B)]
    qvel = torch.as_tensor((0.3 * rng.standard_normal((B, 75))).astype(
        np.float32))
    kin = E.fk(s["tt"], s["m"], qpos)
    pos = torch.stack([kin["xpos"][:, 0], kin["xpos"][:, 1]], 1) + \
        torch.as_tensor(0.05 * rng.standard_normal((B, 2, 3)),
                        dtype=torch.float32)
    q = rng.standard_normal((B, 2, 4))
    quat = torch.as_tensor(q / np.linalg.norm(q, axis=-1, keepdims=True),
                           dtype=torch.float32)
    oqv = torch.as_tensor((0.2 * rng.standard_normal((B, 2, 6))).astype(
        np.float32))
    return qpos, qvel, torch.cat([pos, quat], -1), oqv


def test_terms_and_substep_match_jax(setup):
    """obj_ground_terms on boxes and spheres partly below the ground,
    humanoid_obj_contacts on objects inside the body and obj_substep with
    the humanoid's wrench, B=3 × 2 objects, against the JAX functions
    vmapped over envs: forces and torques within 1e-5 of the largest
    entry (1e-4 absolute floor: springs of 3·10⁴ N/m), W likewise, the
    substep's pose 1e-6, velocity 1e-5."""
    from uhc_tpu.physics import engine as JE
    from uhc_tpu.physics import objects as JO
    from uhc_tpu_torch.physics import engine as E
    from uhc_tpu_torch.physics import objects as O

    s = setup
    jom, om = _models()
    rng = np.random.default_rng(21)
    qpos, qvel, oq, ov = _near_body(s, 3, rng)
    # objects sunk 2-6 cm into the ground for the ground terms
    gq = oq.clone()
    gq[..., :3] = torch.as_tensor(rng.uniform(-1, 1, (3, 2, 3)),
                                  dtype=torch.float32)
    gq[..., 2] = torch.as_tensor([[0.08, 0.05], [0.13, 0.09], [0.1, 0.04]])
    j = lambda x: jnp.asarray(x.numpy())   # noqa: E731
    got = O.obj_ground_terms(s["m"], om, gq[..., :3], gq[..., 3:7],
                             ov[..., :3], ov[..., 3:])
    want = jax.vmap(lambda p, q, v, w: JO.obj_ground_terms(
        s["jm"], jom, p, q, v, w))(j(gq[..., :3]), j(gq[..., 3:7]),
                                   j(ov[..., :3]), j(ov[..., 3:]))
    assert float(got[0][..., 2].abs().min()) > 0, "an object not in contact"
    for a, b in zip(want, got):
        close(a, b.numpy(), 1e-4 + 1e-5 * float(np.abs(a).max()))

    kin = E.fk(s["tt"], s["m"], qpos)
    vel = E.velocities(s["tt"], kin, qvel)
    got = O.humanoid_obj_contacts(s["tt"], s["m"], kin, vel, om, oq[..., :3],
                                  oq[..., 3:7], ov[..., :3], ov[..., 3:])

    def jax_contacts(qp, qv, p, q, v, w):
        k = JE.fk(s["jt"], s["jm"], qp)
        return JO.humanoid_obj_contacts(
            s["jt"], s["jm"], k, JE.velocities(s["jt"], k, qv), jom, p, q, v,
            w)

    want = jax.jit(jax.vmap(jax_contacts))(
        j(qpos), j(qvel), j(oq[..., :3]), j(oq[..., 3:7]), j(ov[..., :3]),
        j(ov[..., 3:]))
    assert float(got[0].abs().max()) > 1.0, "no contact generated"
    for a, b in zip(want, got):
        close(a, b.numpy(), 1e-4 + 1e-5 * float(np.abs(a).max()))
    F_ext, T_ext = got[2], got[3]
    nq, nv = O.obj_substep(s["m"], om, gq, ov, F_ext, T_ext)
    jq, jv = jax.vmap(lambda q, v, f, t: JO.obj_substep(
        s["jm"], jom, q, v, f, t))(j(gq), j(ov), j(F_ext), j(T_ext))
    close(jq, nq.numpy(), 1e-6)
    close(jv, nv.numpy(), 1e-5)


def test_contact_wrench_is_equal_and_opposite(setup):
    """A 0.3 m box on the pelvis: the humanoid's and the box's forces
    cancel (as tests/test_obj_dynamics.py:50-69)."""
    from uhc_tpu_torch.physics import engine as E
    from uhc_tpu_torch.physics import objects as O

    s = setup
    om = O.make_obj_model([{"kind": "box", "size": [0.3, 0.3, 0.3],
                            "mass": 2.0}], "cpu")
    qpos = s["lib"]["qpos"][0:1, 0]
    kin = E.fk(s["tt"], s["m"], qpos)
    vel = E.velocities(s["tt"], kin, torch.zeros(1, 75))
    quat = torch.tensor([[[1.0, 0, 0, 0]]])
    z = torch.zeros(1, 1, 3)
    Fb, Tb, Fo, To = O.humanoid_obj_contacts(s["tt"], s["m"], kin, vel, om,
                                             kin["xpos"][:, 0:1], quat, z, z)
    tot_h = Fb.sum(1)[0].numpy()
    assert np.linalg.norm(tot_h) > 1.0, "no contact generated"
    close(tot_h, -Fo[0, 0].numpy(), 1e-4, 1e-4)


@pytest.mark.parametrize("kind,size,z0,rest", [
    ("box", [0.15, 0.15, 0.15], 0.5, 0.15), ("sphere", 0.1, 0.4, 0.1)])
def test_drop_settles(setup, kind, size, z0, rest):
    """A free box (sphere) dropped from 0.5 m (0.4 m) settles within 2 s
    at 450 Hz: resting height within 2 cm of its half extent (radius),
    every velocity under 0.05, no lateral drift, upright (the checks of
    tests/test_obj_dynamics.py:24-47)."""
    from uhc_tpu_torch.physics import objects as O

    s = setup
    om = O.make_obj_model([{"kind": kind, "size": size, "mass": 2.0 if
                            kind == "box" else 1.0}], "cpu")
    qp = torch.tensor([[[0.0, 0.0, z0, 1.0, 0.0, 0.0, 0.0]]])
    qv = torch.zeros(1, 1, 6)
    z3 = torch.zeros(1, 1, 3)
    for _ in range(900):
        qp, qv = O.obj_substep(s["m"], om, qp, qv, z3, z3)
    qp, qv = qp[0, 0].numpy(), qv[0, 0].numpy()
    assert abs(qp[2] - rest) < 0.02, f"rest height {qp[2]}"
    assert np.all(np.abs(qv) < 0.05), f"not at rest: {qv}"
    if kind == "box":
        assert np.all(np.abs(qp[:2]) < 0.01)
        assert qp[3] > 0.99


def test_do_simulation_with_objects_matches_jax(setup):
    """One exact control step (15 substeps, uhc_implicit's env) of B=2
    humanoids, each with a box and a sphere inside its body, seeded
    actions: qpos 1e-5, qvel 1e-3 (the exact chain's bounds), the objects'
    poses 1e-5, velocities 1e-3; the objects move; without `obj` the step
    is the one engine.substep gives."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.envs import humanoid_im as H

    s = setup
    jom, om = _models()
    rng = np.random.default_rng(22)
    qpos, qvel, oq, ov = _near_body(s, 2, rng)
    qvel = 0.1 * qvel
    oq, ov = oq.reshape(2, 14), 0.0 * ov.reshape(2, 12)
    env = s["cfg"].env
    act = torch.as_tensor((0.05 * rng.standard_normal((2, 75))).astype(
        np.float32))
    tb = s["lib"]["qpos"][torch.arange(2), 1, 7:]
    out = H.do_simulation(s["tt"], s["m"], env, qpos, qvel, act, tb, 1.0,
                          obj=(om, oq, ov))
    j = lambda x: jnp.asarray(x.numpy())   # noqa: E731
    want = jax.jit(jax.vmap(lambda qp, qv, a, t, q, v: JH.do_simulation(
        s["jt"], s["jm"], s["jcfg"].env, qp, qv, a, t, 1.0,
        obj=(jom, q, v))))(j(qpos), j(qvel), j(act), j(tb), j(oq), j(ov))
    for a, b, tol in zip(want, out, (QPOS_TOL, QVEL_TOL, QPOS_TOL,
                                     QVEL_TOL)):
        close(a, b.numpy(), tol)
    assert float((out[2] - oq).abs().max()) > 1e-4, "objects did not move"


def test_track_played_back_by_both_steps(setup):
    """The library carries the clips' obj_pose track (zero-filled for the
    clips without one, as in JAX) and env_reset starts at it; env_step
    and the batched step (the plain chain here; a kernel on a card) play
    it back frame by frame (tests/test_obj_scene.py:46-86); state_where
    keeps the field None where both states lack it."""
    from uhc_tpu_torch.data.dataset import neutral_from_library
    from uhc_tpu_torch.envs import humanoid_im as H

    s = setup
    lib = s["lib"]
    assert lib["obj_pose"].shape == (6, T, 7)
    for i, k in enumerate(s["keys"]):
        want = (s["seqs"][k]["obj_pose"][:T] if i < 3
                else np.zeros((T, 7), np.float32))
        np.testing.assert_array_equal(lib["obj_pose"][i].numpy(), want)
    nq, nv = neutral_from_library(lib)
    env = s["cfg"].env
    seq = torch.tensor([0, 2])
    st = H.env_reset(s["tt"], s["m"], env, seq, lib, nq, nv,
                     start_ind=torch.tensor([0, 2]), train=False)
    act = torch.zeros(2, 75)
    step = H.make_env_step_batched(s["tt"], env)
    bst = st
    for t in range(1, 4):
        st = H.env_step(s["tt"], s["m"], env, st, act, lib, s["jpw"],
                        s["jpw"][1:], train=False)[0]
        bst = step(s["m"], bst, act, lib, s["jpw"], s["jpw"][1:],
                   train=False)[0]
        want = lib["obj_pose"][seq, torch.tensor([0, 2]) + t]
        assert torch.equal(st.obj_qpos, want)
        assert torch.equal(bst.obj_qpos, want)
    assert not torch.equal(lib["obj_pose"][0, 0], lib["obj_pose"][0, 3])
    mask = torch.tensor([True, False])
    kept = H.state_where(mask, st, bst)
    assert kept.obj_qvel is None
    assert torch.equal(kept.obj_qpos, st.obj_qpos)
