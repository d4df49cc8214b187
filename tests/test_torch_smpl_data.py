"""SMPL-H / SMPL-X model data and exact-mass shapes against the JAX
package: load_smplh_data on a 52-joint file written from synthetic data
(the real model files are not redistributable, as in tests/test_smplh.py),
the exact bone offsets and the 52- and 55-body models built from them, the
agent taking those offsets, SMPL-H vertex metrics, the exact hull mass
properties of model_from_betas_exact (both packages on their native mesh
toolkit, the default of each), an exact-mass shaped library, and one
SMPL-H control step on the data-built model."""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (big_env_cfg, close, few_threads, jax_cfg,
                                load_both)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

GAIT = "sample_data/gait_clips.pkl"
SHAPE = "sample_data/shape_clips.pkl"
FRAMES = 10


def _write_npz(path, sd):
    """A model file in the layout of the SMPL-H release."""
    np.savez(path, v_template=np.asarray(sd.v_template),
             shapedirs=np.asarray(sd.shapedirs),
             J_regressor=np.asarray(sd.j_regressor),
             weights=np.asarray(sd.weights))
    return str(path)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The stand-in on both sides (`load_both`), and 52- and 55-joint
    model files. The hull mass properties of the exact-mass tests run on
    each package's native mesh toolkit, the default of both."""
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data

    d = tmp_path_factory.mktemp("data")
    (jt, jm), (tt, tm) = load_both(d)
    files = {nj: _write_npz(d / f"model{nj}.npz", synthetic_smpl_data(nj=nj))
             for nj in (24, 52, 55)}
    yield dict(jt=jt, jm=jm, tt=tt, tm=tm, m=model_from_numpy(tm, "cpu"),
               files=files, dir=d)


@pytest.mark.parametrize("nj", [52, 55])
def test_load_smplh_data_matches_jax(both, nj):
    """Both loaders read the file to the same arrays, keeping every joint;
    a 24-joint file is refused (ValueError) by both; the synthetic data is
    the JAX package's to the bit; LBS on the 52 / 55-joint tree: at the
    zero pose its joints are the regressed ones (1e-5), at a seeded pose
    it equals JAX's (1e-5)."""
    from uhc_tpu.smpl import lbs as JL
    from uhc_tpu_torch.smpl import lbs as L

    for a, b in zip(dataclasses.astuple(JL.synthetic_smpl_data(nj=nj)),
                    dataclasses.astuple(L.synthetic_smpl_data(nj=nj))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    path = both["files"][nj]
    jd, td = JL.load_smplh_data(path), L.load_smplh_data(path)
    assert td.j_regressor.shape == (nj, 512) and td.weights.shape[1] == nj
    for a, b in zip(dataclasses.astuple(jd), dataclasses.astuple(td)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for load in (JL.load_smplh_data, L.load_smplh_data):
        with pytest.raises(ValueError, match="52/55"):
            load(both["files"][24])
    betas = np.zeros(16, np.float32)
    verts, joints = L.lbs(td, np.zeros((nj, 3), np.float32), betas,
                          np.zeros(3, np.float32))
    close(L.shaped_joints(td, betas), joints, 1e-5)
    rng = np.random.default_rng(nj)
    pose = (0.4 * rng.standard_normal((nj, 3))).astype(np.float32)
    betas = (0.5 * rng.standard_normal(16)).astype(np.float32)
    jv, jj = JL.lbs(jd, jnp.asarray(pose), jnp.asarray(betas))
    tv, tj = L.lbs(td, pose, betas)
    close(jv, tv, 1e-5)
    close(jj, tj, 1e-5)


@pytest.mark.parametrize("nj", [52, 55])
def test_offsets_and_models_from_data_match_jax(both, nj):
    """smplh_offsets_from_betas (zero and seeded betas) and the model
    built from the offsets (smplh_model_from_data at 52 joints,
    smplx_model_from_data at 55) vs JAX: every offset and every leaf of
    the model within 1e-6; the bodies carry the data's offsets, not the
    anthropometric defaults."""
    from uhc_tpu.smpl import lbs as JL
    from uhc_tpu.smpl import smplh as JSH
    from uhc_tpu_torch.physics.model import model_to_numpy
    from uhc_tpu_torch.smpl import lbs as L
    from uhc_tpu_torch.smpl import smplh as SH

    s = both
    jd, td = (JL.load_smplh_data(s["files"][nj]),
              L.load_smplh_data(s["files"][nj]))
    for betas in (np.zeros(16, np.float32), (0.7 * np.random.default_rng(
            7).standard_normal(16)).astype(np.float32)):
        joff, jroot = JL.smplh_offsets_from_betas(jd, jnp.asarray(betas))
        toff, troot = L.smplh_offsets_from_betas(td, betas)
        assert list(joff) == list(toff) and len(toff) == nj - 1
        for k in joff:
            close(joff[k], toff[k], 1e-6)
        close(jroot, troot, 1e-6)
    build = {52: ("smplh_model_from_data", "smplh_topology", "smplh_model"),
             55: ("smplx_model_from_data", "smplx_topology",
                  "smplx_model")}[nj]
    jmodel = getattr(JSH, build[0])(s["jt"], s["jm"], jd)
    tmodel = model_to_numpy(getattr(SH, build[0])(s["tt"], s["tm"], td))
    for f in dataclasses.fields(jmodel):
        close(getattr(jmodel, f.name), tmodel[f.name], 1e-6)
    names = list(getattr(SH, build[1])().body_names)
    toff, _ = L.smplh_offsets_from_betas(td, np.zeros(16, np.float32))
    anthro = model_to_numpy(getattr(SH, build[2])(s["tt"], s["tm"]))
    for name in ("L_Index1", "R_Thumb3", "L_Knee", "Head"):
        i = names.index(name)
        close(toff[name], tmodel["body_pos"][i], 0.0)
    assert not np.allclose(anthro["body_pos"][names.index("L_Index1")],
                           tmodel["body_pos"][names.index("L_Index1")])
    assert list(SH._dfs_order()) == list(JSH._dfs_order())
    np.testing.assert_array_equal(JSH.ee_indices_smplh(),
                                  SH.ee_indices_smplh())


@pytest.fixture(scope="module")
def clips(both):
    """A motion file of two gait clips cut to FRAMES."""
    from uhc_tpu_torch.data.dataset import load_motion_file

    seqs = list(load_motion_file(GAIT).items())[:2]
    path = str(both["dir"] / "clips.pkl")
    with open(path, "wb") as f:
        pickle.dump({k: {"pose_aa": np.asarray(d["pose_aa"])[:FRAMES],
                         "trans": np.asarray(d["trans"])[:FRAMES]}
                     for k, d in seqs}, f)
    return path


def test_agent_takes_exact_smplh_offsets(both, clips, tmp_path):
    """CopycatAgent(robot_model="smplh", smpl_data=<52-joint file>) builds
    SMPL-H with the data's exact offsets (tests/test_smplh.py:223-265),
    not the anthropometric ones, keeps the 52-joint data for the vertex
    metrics, and its eval reports finite penetration and skate; a 24-joint
    file keeps the anthropometric model and no vertex metrics, as the JAX
    agent's fallback."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn.agent import CopycatAgent
    from uhc_tpu_torch.smpl.lbs import (load_smplh_data,
                                        smplh_offsets_from_betas)
    from uhc_tpu_torch.smpl.smplh import smplh_model

    cfg = dataclasses.replace(Config.uhc_implicit(),
                              env=big_env_cfg("smplh"))
    kw = dict(num_envs=2, horizon=2, device="cpu", max_seq_len=FRAMES)
    agent = CopycatAgent(cfg, clips, results_dir=str(tmp_path / "a"),
                         smpl_data=both["files"][52], **kw)
    assert agent.topo.nbody == 52
    off, _ = smplh_offsets_from_betas(load_smplh_data(both["files"][52]),
                                      np.zeros(16, np.float32))
    names = list(agent.topo.body_names)
    bp = agent.model.body_pos.numpy()
    for name in ("L_Index1", "R_Thumb3", "L_Middle2", "Head"):
        close(off[name], bp[names.index(name)], 1e-6)
    anthro = smplh_model(both["tt"], both["tm"]).body_pos
    assert not np.allclose(anthro[names.index("L_Index1")],
                           bp[names.index("L_Index1")], atol=1e-6)
    assert agent.smpl_data.j_regressor.shape[0] == 52
    assert agent.expert_lib["wbpos"].shape[-1] == 52 * 3
    summary = agent.eval_policy(track_best=False)["summary"]
    assert {"penetration", "skate"} <= set(summary)
    assert all(np.isfinite(v) for v in summary.values())
    fallback = CopycatAgent(cfg, clips, results_dir=str(tmp_path / "b"),
                            smpl_data=both["files"][24], **kw)
    close(anthro, fallback.model.body_pos, 0.0)
    assert fallback.smpl_data is None


def test_smplh_vertex_metrics_match_jax_lbs(both):
    """vertices_from_qpos on 160-wide SMPL-H qpos: qpos_to_smplh inverts
    smplh_to_qpose (angles under π, 1e-5), and the vertices equal the JAX
    package's 52-joint LBS of the pose (1e-5)."""
    from uhc_tpu.smpl import lbs as JL
    from uhc_tpu_torch.learn.metrics import vertices_from_qpos
    from uhc_tpu_torch.smpl import lbs as L
    from uhc_tpu_torch.smpl.smplh import qpos_to_smplh, smplh_to_qpose

    rng = np.random.default_rng(9)
    T = 3
    pose = (0.5 * rng.standard_normal((T, 156))).astype(np.float32)
    trans = rng.standard_normal((T, 3)).astype(np.float32)
    ro = np.array([0.0, 0.1, 0.9], np.float32)
    qpos = smplh_to_qpose(pose, ro, trans).numpy()
    assert qpos.shape == (T, 160)
    aa, tr = qpos_to_smplh(qpos, ro)
    close(pose.reshape(T, 52, 3), aa, 1e-5)
    close(trans, tr, 1e-6)
    betas = (0.5 * rng.standard_normal(16)).astype(np.float32)
    jd = JL.load_smplh_data(both["files"][52])
    want = jax.vmap(lambda p, t: JL.lbs(jd, p, jnp.asarray(betas), t)[0])(
        jnp.asarray(pose.reshape(T, 52, 3)), jnp.asarray(trans))
    got = vertices_from_qpos(qpos, L.load_smplh_data(both["files"][52]),
                             betas, ro)
    close(want, got, 1e-5)


def test_model_from_betas_exact_matches_jax(both):
    """Exact hull mass properties on the stand-in with 2048-vertex
    synthetic data (80-95 vertices a body, every body hulled), zero and
    seeded betas, vs the JAX function, both on the native toolkit: mass and
    moments within 1e-6 relative, COM within 1e-6, the principal-frame
    quaternion within 1e-5 (float32 vertices one ulp apart on the two
    sides move the moments by ~1e-7 relative, and an eigenvector by that
    over the relative gap of its moments: 2e-6 measured; no body picks
    another hull or flips its frame), the rest of the model equal to
    model_from_betas with the anatomical joint ranges."""
    from uhc_tpu.smpl.lbs import synthetic_smpl_data as jax_synth
    from uhc_tpu.smpl.lbs import vertex_body_assignment as jax_assign
    from uhc_tpu.smpl.robot import model_from_betas_exact as jax_exact
    from uhc_tpu_torch.smpl.lbs import (synthetic_smpl_data,
                                        vertex_body_assignment)
    from uhc_tpu_torch.smpl.robot import (model_from_betas,
                                          model_from_betas_exact,
                                          rel_joint_ranges)

    s = both
    jsd, sd = jax_synth(V=2048), synthetic_smpl_data(V=2048)
    assign = vertex_body_assignment(sd)
    np.testing.assert_array_equal(jax_assign(jsd), assign)
    assert np.bincount(assign, minlength=24).min() >= 8
    for betas in (np.zeros(16, np.float32), (0.8 * np.random.default_rng(
            1).standard_normal(16)).astype(np.float32)):
        jm = jax_exact(s["jt"], s["jm"], jsd, jnp.asarray(betas), assign)
        tm = model_from_betas_exact(s["tt"], s["m"], sd, betas, assign)
        close(jm.body_mass, tm.body_mass, 0.0, 1e-6)
        close(jm.body_inertia, tm.body_inertia, 0.0, 1e-6)
        close(jm.body_ipos, tm.body_ipos, 1e-6)
        close(jm.body_iquat, tm.body_iquat, 1e-5)
        scaled = model_from_betas(s["tt"], s["m"], sd, betas, assign)
        assert not np.isclose(tm.body_mass, scaled.body_mass).any()
        close(rel_joint_ranges(s["tt"], scaled), tm.jnt_range, 0.0)
        for k in ("body_pos", "contact_point", "sc_radius"):
            close(getattr(scaled, k), getattr(tm, k), 0.0)


def test_exact_mass_shaped_library_matches_jax(both):
    """build_shaped_library(exact_mass=True) over the 8 shape clips on
    2048-vertex synthetic data vs JAX: qpos and wbpos within 1e-5, the
    shape observation exact, weight within 1e-6 relative; the library dim
    on the same leaves, the four hull leaves among them (each a leaf the
    per-env kernel gathers), the per-sequence models within 1e-6 of each
    leaf's largest entry but the COMs (within 1e-6 m: their rounding is
    the vertices', not their own size's) and the principal-frame
    quaternions (1e-5), as in test_model_from_betas_exact_matches_jax."""
    from uhc_tpu.data.dataset import build_shaped_library as jax_shaped
    from uhc_tpu.data.dataset import load_motion_file as jax_motion
    from uhc_tpu.physics.model import model_batch_axes as jax_axes
    from uhc_tpu.smpl.lbs import synthetic_smpl_data as jax_synth
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_shaped_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.control_step import PE_MODEL_LEAVES
    from uhc_tpu_torch.physics.model import model_batch_axes
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data

    s = both
    cfg = Config.uhc_implicit_shape().env
    jlib, jkeys, jml = jax_shaped(s["jt"], s["jm"], jax_motion(SHAPE),
                                  jax_synth(V=2048), jax_cfg(cfg),
                                  max_len=FRAMES, exact_mass=True)
    lib, keys, ml = build_shaped_library(s["tt"], s["m"],
                                         load_motion_file(SHAPE),
                                         synthetic_smpl_data(V=2048), cfg,
                                         max_len=FRAMES, exact_mass=True)
    assert keys == jkeys
    close(jlib["qpos"], lib["qpos"], 1e-5)
    close(jlib["wbpos"], lib["wbpos"], 1e-5)
    np.testing.assert_array_equal(np.asarray(jlib["shape_obs"]),
                                  lib["shape_obs"].numpy())
    close(jlib["weight"], lib["weight"], 0.0, 1e-6)
    ja = jax_axes(jml)
    batched = {k for k, a in model_batch_axes(ml).items() if a == 0}
    assert batched == {f.name for f in dataclasses.fields(jml)
                       if getattr(ja, f.name) == 0}
    hull = {"body_mass", "body_ipos", "body_inertia", "body_iquat"}
    assert hull <= batched <= set(PE_MODEL_LEAVES)
    absolute = {"body_ipos": 1e-6, "body_iquat": 1e-5}
    for k in batched:
        a = np.asarray(getattr(jml, k))
        err = np.abs(a - getattr(ml, k).numpy()).max()
        if k not in absolute:
            err /= np.abs(a).max()
        assert err <= absolute.get(k, 1e-6), (k, err)


def test_control_step_on_data_built_smplh_matches_jax(both, clips):
    """One SMPL-H control step on the model built from 52-joint data: the
    port's plain chain at (2, 2) (K1d's plain version) vs the JAX package's
    XLA chain at PCG-2 (uhc_tpu.physics.solver.make_do_simulation) on the
    JAX-built model, over its clip frames with seeded rates and actions:
    qpos 1e-5, qvel 1e-3."""
    from uhc_tpu.physics import solver as JS
    from uhc_tpu.smpl import lbs as JL
    from uhc_tpu.smpl.smplh import smplh_model_from_data as jax_from_data
    from uhc_tpu.smpl.smplh import smplh_topology as jax_topology
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics import solver as S
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl import lbs as L
    from uhc_tpu_torch.smpl.smplh import smplh_model_from_data, smplh_topology

    s = both
    path = s["files"][52]
    jm = jax_from_data(s["jt"], s["jm"], JL.load_smplh_data(path))
    jm = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jm)
    topo = smplh_topology()
    m = model_from_numpy(smplh_model_from_data(s["tt"], s["tm"],
                                               L.load_smplh_data(path)),
                         "cpu")
    lib, _ = build_expert_library(topo, m, load_motion_file(clips))
    cfg = big_env_cfg("smplh", meta_pd=True)
    rng = np.random.default_rng(11)
    B = 6
    si, ti = rng.integers(0, 2, B), rng.integers(0, FRAMES - 1, B)
    ins = (lib["qpos"][si, ti], torch.tensor(
        (0.05 * rng.standard_normal((B, topo.nv))).astype(np.float32)),
        torch.tensor((0.02 * rng.standard_normal(
            (B, sum(S.action_dims(topo, cfg))))).astype(np.float32)),
        lib["qpos"][si, ti + 1, 7:])
    sim = jax.jit(JS.make_do_simulation(jax_topology(), jax_cfg(cfg), 2))
    qj, vj = sim(jm, *[jnp.asarray(x.numpy()) for x in ins], 1.0)
    qt, vt = S.do_simulation(topo, cfg, m, *ins, 1.0, (2, 2))
    close(qj, qt, 1e-5)
    close(vj, vt, 1e-3)
