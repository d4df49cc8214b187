"""The 55-body SMPL-X family against the JAX package, both built from the
stand-in humanoid: the tree and every model leaf, smplx_to_qpose, the
165-dof expert library (and the refusal of other widths), reset and obs
(as tests/test_smplh.py:122-149 does on the JAX side), one batched env
step through the plain chain, the env's routing to K2 at PCG-2, and the
-DNB=55 host build of the control-step source against its plain version
and its own K1. JAX has no SMPL-X diff weights: both sides take ones."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_big_tree import _states
from test_torch_helpers import (GAIT, chain_tree, close, few_threads,
                                jax_cfg, load_both)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

B = 6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(jax topo, model f32), (port topo, model numpy, model tensors,
    expert library of the six gait clips as 165-dof poses, 10 frames)."""
    from chip_smoke import smplx_pose
    from uhc_tpu.physics.model import model_to_dtype
    from uhc_tpu.smpl.smplh import smplx_model as jax_model
    from uhc_tpu.smpl.smplh import smplx_topology as jax_topo
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.smplh import smplx_model, smplx_topology

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    jx = model_to_dtype(jax_model(jt, jm), jnp.float32)
    tx = smplx_model(tt, tm)
    m = model_from_numpy(tx, "cpu")
    seqs = {k: {"pose_aa": smplx_pose(v["pose_aa"])[:10],
                "trans": np.asarray(v["trans"])[:10]}
            for k, v in load_motion_file(GAIT).items()}
    lib, _ = build_expert_library(smplx_topology(), m, seqs)
    return (jax_topo(), jx), (smplx_topology(), tx, m, lib)


def _cfg(**kw):
    from uhc_tpu_torch.config.config import Config

    return dataclasses.replace(Config.uhc_implicit().env, **kw)


def test_topology_and_model_match_jax(setup):
    """55 bodies (nq 169, nv 168), the same names, parents and depth-first
    order, Jaw and the eyes under the Head (head_index 13, as the JAX test
    asserts), end effectors by name, and every model leaf within 1e-5 (the
    two packages load the stand-in's meshes with their own float32
    code); the face bodies are the micro-bodies of smplx_model."""
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics.model import Model
    from uhc_tpu_torch.smpl import smplh as X
    from uhc_tpu_torch.smpl.constants import ee_indices, head_index
    from uhc_tpu.smpl import smplh as JX
    from uhc_tpu.smpl.constants import ee_indices as jax_ee

    (jt, jm), (tt, tx, _, _) = setup
    assert (tt.nbody, tt.nq, tt.nv) == (55, 169, 168)
    assert tuple(tt.body_names) == tuple(jt.body_names)
    assert tuple(tt.parents) == tuple(jt.parents)
    assert X.SMPLX_BONE_ORDER_NAMES == JX.SMPLX_BONE_ORDER_NAMES
    for name in ("SMPLX_PARENTS", "SMPLX_2_MUJOCO", "MUJOCO_2_SMPLX",
                 "SMPLX_MUJOCO_PARENTS"):
        assert np.array_equal(getattr(X, name), getattr(JX, name)), name
    assert np.array_equal(X._dfs_order_generic(X.SMPLH_PARENTS),
                          JX.SMPLH_2_MUJOCO)
    tt.subtree_end()
    head = head_index(tt)
    assert head == 13
    for n in ("Jaw", "L_Eye_Smplhf", "R_Eye_Smplhf"):
        i = tt.body_names.index(n)
        assert tt.parents[i] == head
        assert tx.body_mass[i] == np.float32(0.05)
        assert tx.contact_mask[i].sum() == 0
    assert np.array_equal(ee_indices(tt), jax_ee(jt))
    assert sum(H.action_dims(tt, _cfg())) == 162 + 6
    for f in dataclasses.fields(Model):
        close(np.asarray(getattr(jm, f.name)), getattr(tx, f.name), 1e-5,
              1e-5)


def test_smplx_to_qpose_matches_jax(setup):
    """A 165-dof pose (a gait clip's body dofs, jaw and eyes at 0.1,
    seeded finger angles) through smplx_to_qpose on both sides, with and
    without trans: within 1e-5."""
    from chip_smoke import smplx_pose
    from uhc_tpu.smpl.smplh import smplx_to_qpose as jax_q
    from uhc_tpu_torch.data.dataset import load_motion_file
    from uhc_tpu_torch.smpl.smplh import smplx_to_qpose

    _, (_, tx, _, _) = setup
    clip = next(iter(load_motion_file(GAIT).values()))
    pose = smplx_pose(clip["pose_aa"])[:12]
    pose[:, 75:] = 0.2 * np.random.default_rng(0).standard_normal(
        (12, 90)).astype(np.float32)
    ro = tx.body_pos[0]
    for trans in (np.asarray(clip["trans"], np.float32)[:12], None):
        b = smplx_to_qpose(pose, ro, trans)
        assert b.shape == (12, 169)
        close(jax_q(pose, ro, trans), b, 1e-5)


def test_expert_library_takes_165_dof_poses_only(setup):
    """The six clips as 165-dof poses give a (6, 10, 169) library within
    1e-4 of the JAX package's on the same model leaves (finite-difference
    velocities divide float32 rounding by dt); a 72- or 156-dof clip on
    the 55-body tree raises the JAX package's ValueError."""
    from uhc_tpu.data.dataset import build_expert_library as jax_build
    from uhc_tpu.physics.model import Model as JModel
    from uhc_tpu_torch.data.dataset import build_expert_library

    _, (tt, tx, m, lib) = setup
    assert lib["qpos"].shape == (6, 10, 169)
    jmodel = JModel(**{f.name: jnp.asarray(getattr(tx, f.name))
                       for f in dataclasses.fields(JModel)})
    from chip_smoke import smplx_pose
    from uhc_tpu_torch.data.dataset import load_motion_file

    clip = next(iter(load_motion_file(GAIT).values()))
    one = {"c": {"pose_aa": smplx_pose(clip["pose_aa"])[:10],
                 "trans": np.asarray(clip["trans"])[:10]}}
    jlib, _ = jax_build(tt, jmodel, one)
    tlib, _ = build_expert_library(tt, m, one)
    assert set(jlib) == set(tlib)
    for k in jlib:
        close(jlib[k], tlib[k], 1e-4, 1e-5)
    for width in (72, 156):
        bad = {"c": {"pose_aa": np.zeros((4, width), np.float32),
                     "trans": None}}
        with pytest.raises(ValueError, match="165-dof"):
            build_expert_library(tt, m, bad)
        with pytest.raises(ValueError, match="165-dof"):
            jax_build(tt, jmodel, bad)


def test_reset_and_obs_match_jax(setup):
    """env_reset at the first frame of each clip and its obs (meta-PD and
    implicit RFC, as tests/test_smplh.py:138-148): the JAX package's obs
    width and values within 1e-4, finite."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.physics.model import Model as JModel
    from uhc_tpu_torch.envs import humanoid_im as H

    (jt, _), (tt, tx, m, lib) = setup
    cfg = _cfg(meta_pd=True, reactive_v=0, env_init_noise=0.0)
    jm = JModel(**{f.name: jnp.asarray(getattr(tx, f.name))
                   for f in dataclasses.fields(JModel)})
    jlib = {k: jnp.asarray(v.numpy()) for k, v in lib.items()}
    st = H.env_reset(tt, m, cfg, torch.arange(6), lib, lib["qpos"][0, 0],
                     lib["qvel"][0, 0], start_ind=0, train=False)
    obs = H.get_obs(tt, m, cfg, st, lib)
    jobs = jax.vmap(lambda s: JH.get_obs(jt, jm, jax_cfg(cfg), JH.env_reset(
        jt, jm, jax_cfg(cfg), jax.random.PRNGKey(0), s, jlib,
        jlib["qpos"][0, 0], jlib["qvel"][0, 0], train=False), jlib))(
        jnp.arange(6))
    assert obs.shape == (6, H.obs_dim(tt, cfg)) == (6, JH.obs_dim(
        jt, jax_cfg(cfg)))
    assert bool(torch.isfinite(obs).all())
    close(jobs, obs, 1e-4)


def test_batched_env_step_matches_jax(setup):
    """One batched env step on SMPL-X through the plain PCG-5 chain on
    both sides (obs v1, reward, termination) vs
    uhc_tpu.envs.humanoid_im.make_env_step_batched on the same model
    leaves and library, at the bounds of the SMPL-H step
    (tests/test_torch_big_tree.py): qpos 1e-4, qvel 1e-2, obs 1e-2,
    reward 1e-4, the same done and fail flags."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.physics.model import Model as JModel
    from uhc_tpu_torch.envs import humanoid_im as H

    (jt, _), (tt, tx, m, lib) = setup
    cfg = _cfg()
    jm = JModel(**{f.name: jnp.asarray(getattr(tx, f.name))
                   for f in dataclasses.fields(JModel)})
    jst, port = _states(jt, lib, 7)
    jlib = {k: jnp.asarray(v.numpy()) for k, v in lib.items()}
    act = (0.02 * np.random.default_rng(8).standard_normal(
        (B, sum(H.action_dims(tt, cfg))))).astype(np.float32)
    w = np.ones(55, np.float32)
    jstep = jax.jit(lambda s, a: JH.make_env_step_batched(jt, jax_cfg(cfg))(
        jm, s, a, jlib, jnp.asarray(w), jnp.asarray(w[1:]), train=False))
    sj, oj, rj, _, dj = jstep(jst, jnp.asarray(act))
    st, ot, rt, _, dt = H.make_env_step_batched(tt, cfg)(
        m, port, torch.tensor(act), lib, torch.tensor(w),
        torch.tensor(w[1:]), train=False)
    assert ot.shape == (B, H.obs_dim(tt, cfg))
    close(sj.qpos, st.qpos, 1e-4)
    close(sj.qvel, st.qvel, 1e-2)
    close(oj, ot, 1e-2)
    close(rj, rt, 1e-4)
    assert np.array_equal(np.asarray(dj), dt.numpy())
    assert np.array_equal(np.asarray(sj.fail), st.fail.numpy())


@pytest.mark.parametrize("env", [{}, {"UHC_TPU_LANE": "0"},
                                 {"UHC_TPU_LANE_BIG": "0"},
                                 {"UHC_TPU_LANE": "1",
                                  "UHC_TPU_LANE_BIG": "1"}])
def test_env_routes_smplx_to_k2(setup, monkeypatch, env):
    """make_env_step_batched with the SMPL-X model to bake: K2
    (ControlStepSplit) at PCG-2 whatever UHC_TPU_LANE / UHC_TPU_LANE_BIG
    say (the JAX lane route stops at 52 bodies); explicit RFC, per-joint
    meta-PD and a model library run the plain chain, where the JAX
    package runs XLA; a 30-body tree takes the small-tree route, K1 at
    (1, 2), or K2 at PCG-2 under UHC_TPU_LANE=0."""
    from uhc_tpu_torch.config.config import EXPLICIT, META_JOINT, Config
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics.control_step import ControlStep
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit

    _, (tt, _, m, _) = setup
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for meta in (False, True):
        k = H.make_env_step_batched(tt, _cfg(meta_pd=meta),
                                    fused_model=m).kernel
        assert type(k) is ControlStepSplit and k.pcg_iters == (2, 2)
        assert k.topo.nbody == 55 and not k.precond_bf16
    for d in (EXPLICIT, META_JOINT):
        assert H.make_env_step_batched(tt, Config.from_dict("x", d).env,
                                       fused_model=m).kernel is None
    lib = dataclasses.replace(m, friction=m.friction.expand(3).clone())
    assert H.make_env_step_batched(tt, _cfg(), fused_model=lib).kernel \
        is None
    t30, m30 = chain_tree(30)
    k = H.make_env_step_batched(t30, _cfg(), fused_model=m30).kernel
    lane = env.get("UHC_TPU_LANE", "1") == "1"
    assert type(k) is (ControlStep if lane else ControlStepSplit)
    assert k.pcg_iters == ((1, 2) if lane else (2, 2))


def _host55():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from uhc_tpu_torch.csrc import build

    return build.load_host_library(55)


def test_host_build_at_55_bodies(setup):
    """The control-step source built with -DNB=55 as host C++: its layout
    (167,328 workspace floats per env, 256 action columns, about 171 KB of
    shared memory with Xp and Xf as packed triangles), K2's head + tail on
    16 SMPL-X draws held to the plain versions at PCG-2 by chip_smoke's
    `gate_big`, and equal bit for bit to the same build's K1 at (2, 2)."""
    import chip_smoke as C
    from uhc_tpu_torch.csrc import build
    from uhc_tpu_torch.physics import control_step_split as K2

    lib = _host55()
    lay = build.layout(lib)
    assert lay["nbody"] == 55 and lay["maxact"] == 256
    assert lay["workspace"] == 2 * 168 ** 2 + 2 * 55 * 6 * 168 == 167328
    assert 170_000 < 4 * lay["smem_floats"] < 171_000
    (_, _), (tt, _, m, lib_x) = setup
    n = 16
    gen = torch.Generator().manual_seed(24)
    qpos, qvel, tb = C.draw_big_states(lib_x, tt.nv, n, gen, "cpu")
    for meta in (False, True):
        cfg = _cfg(meta_pd=meta)
        step = K2.ControlStepSplit(tt, cfg, m, 2)
        act = 0.02 * torch.randn((n, step.act_dim), generator=gen)
        ins = [x.contiguous().numpy() for x in (qpos, qvel, act, tb)]
        tables = [step.params.ctypes.data, None, step.itab.ctypes.data]
        qm, vm = np.zeros_like(ins[0]), np.zeros_like(ins[1])
        qo, vo = np.zeros_like(ins[0]), np.zeros_like(ins[1])
        q1, v1 = np.zeros_like(ins[0]), np.zeros_like(ins[1])
        X = np.zeros((n, 2, 168, 168), np.float32)

        def ptrs(*a):
            return [x.ctypes.data for x in a]

        dims = (n, step.act_dim, 1.0)
        assert lib.uhc_control_step_head_host(
            *tables, *ptrs(*ins, qm, vm, X), *dims) == 0
        assert lib.uhc_control_step_tail_host(
            *tables, *ptrs(qm, vm, ins[2], ins[3], qo, vo, X), *dims) == 0
        assert lib.uhc_control_step_host(
            *tables, *ptrs(*ins, q1, v1), *dims) == 0
        assert np.array_equal(qo, q1) and np.array_equal(vo, v1)
        tins = [torch.tensor(x) for x in ins]
        plain32, plain64 = C.plain_pair(tt, cfg, m, tins, (2, 2))

        def moved(e, cfg=cfg, tins=tins):
            return [C.moved_steps(tt, cfg, m, tins, e, dt)
                    for dt in (torch.float64, torch.float32)]

        errs, fails = C.gate_big(f"host K2-55 meta={meta}",
                                 (torch.tensor(qo), torch.tensor(vo)),
                                 plain32, plain64, moved)
        assert not fails, (fails, errs)
