"""Design populations and the MJCF exporter against the JAX package:
smpl/design.py (the parameter layout, get / set, the gradient through
set_params, a population as a model library through both batched env
steps, gnn_edges), smpl/mjcf_export.py (the exported strings on the
stand-in, remove_toe's tree and masterfoot, and the round trip through the
port's MJCF loader) and the two CLIs that call it. Both packages load the
stand-in from one written file; parameters are made from a seed with
numpy."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (GAIT, batched_steps_both, close,
                                few_threads, load_both)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

SPECS = {
    "offset_len": {"offset": {"type": "xyz", "lb": -0.4, "ub": 0.4},
                   "bone_len": {"lb": 0.02, "ub": 0.7}},
    "xz_ang_beta": {"offset": {"type": "xz", "lb": [-0.4, -0.3],
                               "ub": [0.4, 0.3]},
                    "bone_ang": {"lb": -3.1, "ub": 3.1},
                    "beta": {"lb": -3.0, "ub": 3.0, "n": 4}},
}
FRAMES = 20


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The stand-in on both sides, the port's model as CPU tensors."""
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    return dict(jt=jt, jm=jm, tt=tt, tm=tm, m=model_from_numpy(tm, "cpu"))


def _spaces(s, spec, mapping):
    from uhc_tpu.smpl.design import DesignSpace as JDS
    from uhc_tpu_torch.smpl.design import DesignSpace

    return (JDS(s["jt"], SPECS[spec], mapping),
            DesignSpace(s["tt"], SPECS[spec], mapping))


def _leaves_close(jm, tm, atol):
    from uhc_tpu_torch.physics.model import Model

    for f in dataclasses.fields(Model):
        close(getattr(jm, f.name), getattr(tm, f.name), atol)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_layout_and_names(both, spec):
    jds, ds = _spaces(both, spec, "clip")
    assert ds.n_params == jds.n_params
    assert ds.param_names() == jds.param_names()
    assert ds.body_idx == jds.body_idx
    if spec == "offset_len":
        assert ds.n_params == 23 * 4
        assert "L_Knee_offset_x" in ds.param_names()


@pytest.mark.parametrize("mapping", ["clip", "sin", "none"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_get_set_match_jax(both, spec, mapping):
    """get_params equal to 1e-6; set_params of a seeded move every leaf
    equal to 1e-6; under "none" setting the current parameters gives the
    model back (offsets to 1e-5, as the JAX test holds them)."""
    s = both
    jds, ds = _spaces(s, spec, mapping)
    beta = np.linspace(-1, 1, 4).astype(np.float32)
    pj = jds.get_params(s["jm"], beta if "beta" in SPECS[spec] else None)
    pt = ds.get_params(s["m"], beta if "beta" in SPECS[spec] else None)
    close(pj, pt, 1e-6)
    move = (0.2 * np.random.default_rng(2).standard_normal(ds.n_params)
            ).astype(np.float32)
    p = pt.numpy() + move
    _leaves_close(jds.set_params(s["jm"], jnp.asarray(p)),
                  ds.set_params(s["m"], torch.tensor(p)), 1e-6)
    if mapping == "none":
        close(s["m"].body_pos, ds.set_params(s["m"], pt).body_pos, 1e-5)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_gradient_matches_jax(both, spec):
    """d sum(body_pos²) / d params through autograd against jax.grad:
    relative 1e-5 of the largest entry, and not zero."""
    s = both
    jds, ds = _spaces(s, spec, "clip")
    p0 = ds.get_params(s["m"]).numpy()
    gj = jax.grad(lambda p: jnp.sum(
        jds.set_params(s["jm"], p).body_pos ** 2))(jnp.asarray(p0))
    p = torch.tensor(p0, requires_grad=True)
    (ds.set_params(s["m"], p).body_pos ** 2).sum().backward()
    gj = np.asarray(gj)
    assert np.abs(gj).max() > 0
    close(gj, p.grad, 1e-5 * np.abs(gj).max())


def test_population_through_batched_steps(both):
    """Four designs (the current parameters moved by seeded noise) as a
    library with every leaf batched, built by the port's `population` and
    by jax.vmap of set_params (equal to 1e-6). The port's batched step
    over it builds no kernel (the library batches leaves the per-env
    kernel does not gather) and runs its plain chain; three steps of 4
    envs (one per design) agree at the rollout tests' bounds (obs 2e-4,
    rewards 5e-6, qpos 1e-3) with the JAX XLA chain over the same
    designs. The JAX chain fails on the vmapped library itself (its
    batched dt meets the dofs' gains in the PD torque), so it is given
    the same library with the leaves every design shares unbatched."""
    from uhc_tpu.data.dataset import build_expert_library as jax_library
    from uhc_tpu.data.dataset import load_motion_file as jax_motion
    from uhc_tpu.physics.model import model_batch_axes as jax_axes
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.config.config import EnvConfig
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics import solver as S
    from uhc_tpu_torch.physics.model import model_batch_axes

    s = both
    jds, ds = _spaces(s, "offset_len", "clip")
    rng = np.random.default_rng(0)
    pop = (ds.get_params(s["m"]).numpy()[None]
           + 0.1 * rng.standard_normal((4, ds.n_params))).astype(np.float32)
    jlib_m = jax.vmap(lambda p: jds.set_params(s["jm"], p))(jnp.asarray(pop))
    lib_m = ds.population(s["m"], torch.tensor(pop))
    assert set(model_batch_axes(lib_m).values()) == {0}
    assert set(dataclasses.asdict(jax_axes(jlib_m)).values()) == {0}
    assert lib_m.body_pos.shape == (4, 24, 3)
    _leaves_close(jlib_m, lib_m, 1e-6)
    four = dict(list(load_motion_file(GAIT).items())[:4])
    jfour = dict(list(jax_motion(GAIT).items())[:4])
    lib, _ = build_expert_library(s["tt"], s["m"], four, max_len=FRAMES)
    jlib, _ = jax_library(s["jt"], s["jm"], jfour, max_len=FRAMES)
    cfg = EnvConfig()
    acts = 0.1 * rng.standard_normal((3, 4, sum(S.action_dims(s["tt"],
                                                              cfg))))
    jpw, bdw = default_diff_weights()
    shared = {f: getattr(jlib_m, f)[0]
              for f in dataclasses.asdict(jax_axes(jlib_m))
              if bool(jnp.all(getattr(jlib_m, f) == getattr(jlib_m, f)[0]))}
    assert "dt" in shared and "body_pos" not in shared
    step, jout, tout = batched_steps_both(
        (s["jt"], dataclasses.replace(jlib_m, **shared), jlib),
        (s["tt"], lib_m, lib), cfg, np.arange(4), np.array([0, 3, 5, 2]),
        acts, jpw, bdw, jax_fused=False)
    assert step.kernel is None
    for (jst, jobs, jrew), (st, obs, rew) in zip(jout, tout):
        close(jobs, obs, 2e-4)
        close(jrew, rew, 5e-6)
        close(jst.qpos, st.qpos, 1e-3)


def test_gnn_edges(both):
    from uhc_tpu.smpl.design import gnn_edges as jax_edges
    from uhc_tpu_torch.smpl.design import gnn_edges

    e = gnn_edges(both["tt"])
    assert e.shape == (23, 2) and e.dtype == np.int32
    np.testing.assert_array_equal(e, jax_edges(both["jt"]))


def _trees(s, tree):
    """(JAX (topo, model), port (topo, model)) of `tree`."""
    if tree == "standin":
        return (s["jt"], s["jm"]), (s["tt"], s["tm"])
    if tree == "remove_toe":
        from uhc_tpu.smpl.local_robot import remove_toe_model as jrt
        from uhc_tpu_torch.smpl.local_robot import remove_toe_model as trt

        return jrt(s["jt"], s["jm"]), trt(s["tt"], s["tm"])
    from uhc_tpu.smpl.masterfoot import masterfoot_model as jmf
    from uhc_tpu_torch.smpl.masterfoot import masterfoot_model as tmf

    return jmf(s["jt"], s["jm"])[:2], tmf(s["tt"], s["tm"])[:2]


@pytest.mark.parametrize("tree", ["standin", "remove_toe", "masterfoot"])
def test_export_matches_jax_and_round_trips(both, tree, tmp_path):
    """export_mjcf (with and without self-collision spheres and
    actuators) and export_vis_mjcf give the JAX package's strings; the
    port's loader reads the exported file back to the same topology and
    arrays (to 1e-6: 8 significant digits)."""
    import uhc_tpu.smpl.mjcf_export as JE
    import uhc_tpu_torch.smpl.mjcf_export as TE
    from uhc_tpu_torch.smpl.mjcf import load_mjcf_humanoid

    (jt, jm), (tt, tm) = _trees(both, tree)
    for kw in ({}, {"self_collision": True, "actuators": False}):
        xml = TE.export_mjcf(tt, tm, **kw)
        assert xml == JE.export_mjcf(jt, jm, **kw)
    assert TE.export_vis_mjcf(tt, tm, 3) == JE.export_vis_mjcf(jt, jm, 3)
    path = tmp_path / "x.xml"
    path.write_text(xml)
    t2, m2 = load_mjcf_humanoid(str(path))
    assert (t2.nbody, t2.parents, t2.body_names) == (tt.nbody, tt.parents,
                                                     tt.body_names)
    for f in ("body_pos", "body_ipos", "body_mass", "body_inertia",
              "body_iquat", "armature", "jnt_range", "contact_point",
              "contact_mask", "sc_point", "sc_radius"):
        close(np.asarray(getattr(tm, f)), getattr(m2, f),
              1e-6, 1e-6 if f == "body_inertia" else 0.0)


@pytest.mark.parametrize("variant", ["none", "bigfoot", "masterfoot",
                                     "smplh", "smplx", "ball"])
def test_create_smpl_humanoid_cli(both, variant, tmp_path, capsys):
    """cli/create_smpl_humanoid writes the JAX package's export of the
    same variant built from the stand-in."""
    import uhc_tpu.smpl.mjcf_export as JE
    from uhc_tpu.smpl import masterfoot as JMF
    from uhc_tpu.smpl import smplh as JSH
    from uhc_tpu_torch.cli import create_smpl_humanoid

    s = both
    jt, jm = s["jt"], s["jm"]
    if variant == "bigfoot":
        jm = JMF.bigfoot_model(jt, jm)
    elif variant == "masterfoot":
        jt, jm, _ = JMF.masterfoot_model(jt, jm, 30.0)
    elif variant in ("smplh", "smplx"):
        jm = getattr(JSH, f"{variant}_model")(jt, jm)
        jt = getattr(JSH, f"{variant}_topology")()
    elif variant == "ball":
        jt = dataclasses.replace(jt, joint_kind="ball")
    out = str(tmp_path / f"h_{variant}.xml")
    create_smpl_humanoid.main(["--out", out, "--variant", variant])
    assert f"({jt.nbody} bodies, nq={jt.nq})" in capsys.readouterr().out
    with open(out) as f:
        assert f.read() == JE.export_mjcf(jt, jm, name=f"h_{variant}")


def test_create_smpl_mesh_skeleton_cli(both, tmp_path):
    """cli/create_smpl_mesh_skeleton writes the simulation model and a
    vis scene of --num-vis humanoids, the JAX package's exports."""
    import uhc_tpu.smpl.mjcf_export as JE
    from uhc_tpu_torch.cli import create_smpl_mesh_skeleton

    sim, vis = create_smpl_mesh_skeleton.main(
        ["--out-dir", str(tmp_path), "--num-vis", "3"])
    assert os.path.basename(sim) == "humanoid_smpl_neutral_mesh_test.xml"
    with open(sim) as f:
        assert f.read() == JE.export_mjcf(both["jt"], both["jm"])
    with open(vis) as f:
        assert f.read() == JE.export_vis_mjcf(both["jt"], both["jm"], 3)
