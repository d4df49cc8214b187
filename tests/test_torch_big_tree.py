"""The big trees against the JAX package: the 52-body SMPL-H humanoid
(`--robot-model smplh`) and the 48-body masterfoot (`env.masterfoot`),
both built from the stand-in humanoid. Topologies, every model leaf, the
SMPLConverter's remaps and tables, smplh_to_qpose, the expert libraries,
one batched env step on SMPL-H, the agents on both trees and two CPU
epochs of the training CLI (the policy carried across from a JAX agent at
the 52-body widths is in tests/test_torch_control_step_big.py, which has
the time for one more JAX compile).
The clips are the first two of the gait clips, cut to FRAMES frames
(each JAX featurization of a big tree costs seconds); inputs are made from
numpy seeds and handed to both sides."""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (BIG_FAMILIES, GAIT, big_env_cfg, big_trees,
                                close, few_threads, jax_cfg)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

FRAMES = 10
CLIPS = 2
B = 6


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A motion file of the first CLIPS gait clips, cut to FRAMES."""
    from uhc_tpu_torch.data.dataset import load_motion_file

    seqs = list(load_motion_file(GAIT).items())[:CLIPS]
    path = str(tmp_path_factory.mktemp("clips") / "clips.pkl")
    with open(path, "wb") as f:
        pickle.dump({k: {"pose_aa": np.asarray(d["pose_aa"])[:FRAMES],
                         "trans": np.asarray(d["trans"])[:FRAMES]}
                     for k, d in seqs}, f)
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory, clips):
    """{family: (jax topo, model, converter, expert library), (port ...)}
    over the clips, and the stand-in's directory. The JAX package builds
    the masterfoot library (its converter branch); the SMPL-H one is held
    to the JAX agent's in tests/test_torch_control_step_big.py (None
    here)."""
    from uhc_tpu.data.dataset import build_expert_library as jax_build
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    directory = tmp_path_factory.mktemp("standin")
    out = {}
    for fam, ((jt, jm, jc), (tt, tm, tc)) in big_trees(directory).items():
        m = model_from_numpy(tm, "cpu")
        lib, keys = build_expert_library(
            tt, m, load_motion_file(clips), converter=tc,
            base_root_offset=None if tc is None else tm.body_pos[0])
        jlib = None
        if jc is not None:
            jlib, jkeys = jax_build(jt, jm, jax_load_motion(clips),
                                    converter=jc,
                                    base_root_offset=jm.body_pos[0])
            assert keys == jkeys and len(keys) == CLIPS
        out[fam] = ((jt, jm, jc, jlib), (tt, m, tc, lib))
    return out, directory


@pytest.mark.parametrize("family", BIG_FAMILIES)
def test_topology_and_model_match_jax(setup, family):
    """Same tree (bodies, parents, names, depth-first order) and every
    model leaf within 1e-5 (the two packages load the stand-in's meshes
    with their own float32 code)."""
    from uhc_tpu_torch.physics.model import Model, model_to_numpy

    trees, _ = setup
    (jt, jm, _, _), (tt, m, _, _) = trees[family]
    assert tt.nbody == jt.nbody == {"smplh": 52, "masterfoot": 48}[family]
    assert tuple(tt.parents) == tuple(jt.parents)
    assert tuple(tt.body_names) == tuple(jt.body_names)
    # subtrees are contiguous index ranges (the kernel's sums rely on it)
    tt.subtree_end()
    mt = model_to_numpy(m)
    for f in dataclasses.fields(Model):
        close(np.asarray(getattr(jm, f.name)), mt[f.name], 1e-5, 1e-5)


@pytest.mark.parametrize("family", BIG_FAMILIES)
def test_converter_matches_jax(setup, family):
    """The SMPLConverter from the 24-body layout onto the tree (the one the
    masterfoot model builds; for SMPL-H the one the JAX agent remaps its
    reset pose with): every remap of seeded states exact, and the
    diff-weight, gain, gear and torque tables equal."""
    from uhc_tpu.physics.model import Topology as JTopo
    from uhc_tpu.smpl.constants import MUJOCO_BODY_ORDER, MUJOCO_PARENTS
    from uhc_tpu.smpl.converter import SMPLConverter as JConv
    from uhc_tpu_torch.physics.model import Topology
    from uhc_tpu_torch.smpl.converter import SMPLConverter

    trees, _ = setup
    (jt, _, jc, _), (tt, _, tc, _) = trees[family]
    parents = tuple(int(p) for p in MUJOCO_PARENTS)
    if tc is None:
        jc = JConv(JTopo(24, parents, tuple(MUJOCO_BODY_ORDER)), jt, "smplh")
        tc = SMPLConverter(Topology(24, parents, tuple(MUJOCO_BODY_ORDER)),
                           tt, "smplh")
    rng = np.random.default_rng(0)
    q24 = rng.standard_normal((B, 76)).astype(np.float32)
    v24 = rng.standard_normal((B, 75)).astype(np.float32)
    qn = rng.standard_normal((B, tt.nq)).astype(np.float32)
    vn = rng.standard_normal((B, tt.nv)).astype(np.float32)
    for name, x in (("qpos_smpl_2_new", q24), ("qvel_smpl_2_new", v24),
                    ("qpos_new_2_smpl", qn), ("qvel_new_2_smpl", vn)):
        a = np.asarray(getattr(jc, name)(jnp.asarray(x)))
        b = getattr(tc, name)(torch.tensor(x)).numpy()
        assert np.array_equal(a, b), name
    for name in ("get_new_diff_weight", "get_new_jkp", "get_new_jkd",
                 "get_new_a_scale", "get_new_torque_limit"):
        assert np.array_equal(getattr(jc, name)(), getattr(tc, name)()), name


def test_smplh_to_qpose_matches_jax(setup, clips):
    """A gait clip (72 dofs, flat hands: 156) through smplh_to_qpose on
    both sides, with and without its trans: within 1e-5 (float32
    rotation-vector -> quaternion -> Euler conversions)."""
    from uhc_tpu.smpl.smplh import smplh_to_qpose as jax_q
    from uhc_tpu_torch.data.dataset import load_motion_file
    from uhc_tpu_torch.smpl.smplh import smplh_to_qpose

    trees, _ = setup
    _, (_, m, _, _) = trees["smplh"]
    clip = next(iter(load_motion_file(clips).values()))
    pose = np.asarray(clip["pose_aa"], np.float32)
    pose = np.concatenate([pose[:, :66], np.zeros((FRAMES, 90), np.float32)],
                          1)
    ro = m.body_pos[0].numpy()
    for trans in (np.asarray(clip["trans"], np.float32), None):
        a = jax_q(pose, ro, trans)
        b = smplh_to_qpose(pose, ro, trans)
        assert b.shape == (FRAMES, 160)
        close(a, b, 1e-5)


def test_masterfoot_expert_library_matches_jax(setup):
    """The clips on the masterfoot tree, through the converter (sole
    joints at zero): every per-frame feature within 1e-4
    (finite-difference velocities divide float32 rounding by dt = 1/30 s).
    The SMPL-H library is held to the JAX agent's in
    tests/test_torch_control_step_big.py."""
    trees, _ = setup
    (_, _, _, jlib), (_, _, _, lib) = trees["masterfoot"]
    assert set(jlib) == set(lib)
    for k in jlib:
        close(jlib[k], lib[k], 1e-4, 1e-5)


def _states(jt, lib, seed):
    """The same env states on both sides: clip frames + seeded noise."""
    from uhc_tpu.envs.humanoid_im import EnvState as JState
    from uhc_tpu_torch.envs.humanoid_im import EnvState, get_body_quat

    rng = np.random.default_rng(seed)
    seq = rng.integers(0, CLIPS, B)
    start = rng.integers(0, 3, B)
    cur = rng.integers(1, 5, B)
    fr = start + cur
    qpos = np.asarray(lib["qpos"][seq, fr], np.float32).copy()
    qpos[:, 7:] += 0.05 * rng.standard_normal((B, jt.ndof))
    qvel = (np.asarray(lib["qvel"][seq, fr])
            + 0.1 * rng.standard_normal((B, jt.nv))).astype(np.float32)
    prev = np.asarray(lib["qpos"][seq, fr - 1], np.float32)
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
        seq_idx=i32(seq), prev_bquat=jnp.asarray(port.prev_bquat.numpy()),
        done=jnp.zeros(B, bool), fail=jnp.zeros(B, bool),
        end=jnp.zeros(B, bool), percent=jnp.zeros(B),
        rng=jnp.zeros((B, 2), jnp.uint32))
    return jst, port


def test_batched_env_step_on_smplh_matches_jax(setup):
    """One batched env step on SMPL-H (physics through the plain PCG-5
    chain on both sides, obs v1 of width 1680, reward, termination) vs
    uhc_tpu.envs.humanoid_im.make_env_step_batched: qpos 1e-4, qvel 1e-2
    (15 substeps of float32 solves), obs 1e-2 (it holds qvel), reward
    1e-4, the same done and fail flags."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.smpl.smplh import smplh_diff_weights as jax_w
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.smpl.smplh import smplh_diff_weights

    trees, _ = setup
    (jt, jm, _, _), (tt, m, _, lib) = trees["smplh"]
    cfg = big_env_cfg("smplh")
    jcfg = jax_cfg(cfg)
    jst, port = _states(jt, lib, 5)
    # both sides read the port's library (held to the JAX one elsewhere)
    jlib = {k: jnp.asarray(v.numpy()) for k, v in lib.items()}
    nd, vf, meta = H.action_dims(tt, cfg)
    act = (0.02 * np.random.default_rng(6).standard_normal(
        (B, nd + vf + meta))).astype(np.float32)
    (jpw, bdw), (tpw, tbw) = jax_w(), smplh_diff_weights()
    assert np.array_equal(jpw, tpw) and np.array_equal(bdw, tbw)
    jstep = jax.jit(lambda s, a: JH.make_env_step_batched(jt, jcfg)(
        jm, s, a, jlib, jnp.asarray(jpw), jnp.asarray(bdw), train=False))
    sj, oj, rj, _, dj = jstep(jst, jnp.asarray(act))
    st, ot, rt, _, dt = H.make_env_step_batched(tt, cfg)(
        m, port, torch.tensor(act), lib, torch.tensor(tpw),
        torch.tensor(tbw), train=False)
    assert ot.shape == (B, H.obs_dim(tt, cfg)) == (B, JH.obs_dim(jt, jcfg))
    close(sj.qpos, st.qpos, 1e-4)
    close(sj.qvel, st.qvel, 1e-2)
    close(oj, ot, 1e-2)
    close(rj, rt, 1e-4)
    assert np.array_equal(np.asarray(dj), dt.numpy())
    assert np.array_equal(np.asarray(sj.fail), st.fail.numpy())


def test_cli_train_smplh_two_cpu_epochs(clips, tmp_path):
    """`cli/train --robot-model smplh --device cpu` at a tiny size: two
    epochs with finite stats, the checkpoint, and the eval at it over the
    clips on the 52-body tree."""
    from uhc_tpu_torch.cli import train

    out = str(tmp_path / "run")
    agent, hist = train.main([
        "--robot-model", "smplh", "--device", "cpu", "--motion-file", clips,
        "--num-envs", "4", "--horizon", "4", "--epochs", "2", "--seed", "2",
        "--results-dir", out])
    assert agent.topo.nbody == 52 and agent.env_cfg.robot_model == "smplh"
    assert (agent.obs_dim, agent.action_dim) == (1680, 159)
    assert len(hist) == 2
    for st in hist:
        assert all(np.all(np.isfinite(v)) for v in st.values())
        assert st["value_loss"] < st["value_loss_before"]
    assert os.path.exists(agent.checkpoint_path(2))
    with open(os.path.join(out, "eval_0002.json")) as f:
        summary = json.load(f)
    assert summary["num_seqs"] == CLIPS and np.isfinite(summary["mpjpe"])


def test_masterfoot_agent_epoch_on_cpu(clips, tmp_path):
    """The agent with env.masterfoot: 48 bodies, the converter's diff
    weights (sole bodies 0), the JAX package's obs width, one finite
    epoch."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn.agent import CopycatAgent

    cfg = dataclasses.replace(Config.uhc_implicit(),
                              env=big_env_cfg("masterfoot"))
    agent = CopycatAgent(cfg, clips, num_envs=4, horizon=3, seed=1,
                         device="cpu", results_dir=str(tmp_path))
    assert agent.topo.nbody == 48 and agent.converter is not None
    assert np.array_equal(agent.aux["jpos_diffw"].numpy(),
                          agent.converter.get_new_diff_weight())
    soles = [i for i, n in enumerate(agent.topo.body_names) if "_mf" in n]
    assert len(soles) == 24 and agent.aux["jpos_diffw"][soles].sum() == 0
    assert agent.obs_dim == JH.obs_dim(agent.topo, jax_cfg(cfg.env))
    assert agent.action_dim == 147
    st = agent.optimize_policy(0)
    assert all(np.all(np.isfinite(v)) for v in st.values())


@pytest.mark.parametrize("family,extra", [("smplh", {"dr_variants": 2}),
                                          ("masterfoot", {"dr_variants": 4}),
                                          ("smplh", {"smpl_data": "x.pkl"})])
def test_agent_refuses_libraries_on_big_trees(tmp_path, family, extra):
    """As the JAX agent refuses dr_variants on these trees, the port
    refuses model libraries and SMPL model data on them."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn.agent import CopycatAgent

    cfg = dataclasses.replace(Config.uhc_implicit(), env=big_env_cfg(family))
    with pytest.raises(NotImplementedError):
        CopycatAgent(cfg, GAIT, num_envs=2, horizon=2, device="cpu",
                     results_dir=str(tmp_path), **extra)


def test_env_routes_trees_like_jax(setup, monkeypatch):
    """make_env_step_batched with a model to bake: SMPL-H and masterfoot
    take K1d at (2, 2); UHC_TPU_LANE_BIG=0 or UHC_TPU_LANE=0 takes K2 at
    PCG-2; the 24-body tree keeps K1 at (1, 2); a 30-body tree raises."""
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics.control_step import ControlStep
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit
    from uhc_tpu_torch.physics.model import Topology
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    trees, _ = setup
    for fam in BIG_FAMILIES:
        _, (tt, m, _, _) = trees[fam]
        cfg = big_env_cfg(fam)
        for env, split in (({}, False), ({"UHC_TPU_LANE_BIG": "0"}, True),
                           ({"UHC_TPU_LANE": "0"}, True)):
            with monkeypatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                k = H.make_env_step_batched(tt, cfg, fused_model=m).kernel
            assert type(k) is (ControlStepSplit if split else ControlStep)
            assert k.pcg_iters == (2, 2) and k.topo.nbody == tt.nbody
    t24, m24 = load_fixture_humanoid()
    monkeypatch.setenv("UHC_TPU_LANE_BIG", "0")
    k = H.make_env_step_batched(t24, big_env_cfg("smplh"),
                                fused_model=m24).kernel
    assert type(k) is ControlStep and k.pcg_iters == (1, 2)
    t30 = Topology(30, tuple([-1] + list(range(29))),
                   tuple(f"b{i}" for i in range(30)))
    with pytest.raises(NotImplementedError, match="30-body"):
        H.make_env_step_batched(t30, big_env_cfg("smplh"), fused_model=m24)
