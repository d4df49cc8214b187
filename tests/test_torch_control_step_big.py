"""K1d, the big-tree control step (52-body SMPL-H, 48-body masterfoot), on
the CPU: the CUDA source built as host C++ for each tree (-DNB) against
its plain PyTorch version at the big trees' PCG schedule (2, 2), K2's head
and tail on the big trees bit-equal to K1d, the plain chain against the
JAX package's XLA chain at the same PCG count, the tables the kernel
reads, and a seeded JAX agent on SMPL-H carried into the port (widths,
expert library, policy mean). Inputs are clip frames of the gait clips on
each tree plus seeded qvel noise, made with numpy."""
import ctypes
import dataclasses
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (BIG_FAMILIES, GAIT, big_env_cfg, big_trees,
                                close, few_threads, jax_cfg, states)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

B = 6
MODES = ("plain_pd", "meta_pd")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{family: ((jax topo, model, converter), port topo, port model,
    (S, T, nq) clip frames on the tree)}."""
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    out = {}
    built = big_trees(tmp_path_factory.mktemp("standin"))
    for fam, (jax_side, (tt, tm, conv)) in built.items():
        m = model_from_numpy(tm, "cpu")
        lib, _ = build_expert_library(
            tt, m, load_motion_file(GAIT), max_len=20, converter=conv,
            base_root_offset=None if conv is None else tm.body_pos[0])
        out[fam] = (jax_side, tt, m, lib["qpos"].numpy())
    return out


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


def _inputs(frames, act_dim, seed, n=B):
    rng = np.random.default_rng(seed)
    qpos, qvel, tb = states(frames, rng, n)
    act = (0.02 * rng.standard_normal((n, act_dim))).astype(np.float32)
    return [torch.tensor(np.ascontiguousarray(x))
            for x in (qpos, qvel, act, tb)]


def _ptr(a):
    return None if a is None else a.ctypes.data


def _host(step, qpos, qvel, act, tb, rfc_rate=1.0, part="full", X=None):
    """One launch of the host build of the step's tree: K1d (part "full")
    or K2's head or tail."""
    from uhc_tpu_torch.csrc import build

    lib = build.load_host_library(step.topo.nbody)
    assert build.layout(lib)["params"] == step.params.shape[-1]
    ins = [np.ascontiguousarray(x.numpy(), np.float32)
           for x in (qpos, qvel, act, tb)]
    qo, vo = np.zeros_like(ins[0]), np.zeros_like(ins[1])
    head = [_ptr(step.params), None, _ptr(step.itab), *map(_ptr, ins),
            _ptr(qo), _ptr(vo)]
    tail = [qpos.shape[0], act.shape[1], rfc_rate]
    if part == "full":
        assert lib.uhc_control_step_host(*head, *tail) == 0
    else:
        fn = getattr(lib, f"uhc_control_step_{part}_host")
        assert fn(*head, _ptr(X), *tail) == 0
    return qo, vo


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", BIG_FAMILIES)
def test_k1d_source_on_host_matches_plain_version(trees, family, mode):
    """The host build of K1d vs the plain PyTorch version at (2, 2), both
    float32: qpos 1e-5, qvel 1e-3 (the bounds of tests/test_fused_split.py
    on these trees)."""
    _needs_cxx()
    from uhc_tpu_torch.physics import control_step as CS

    _, topo, m, frames = trees[family]
    cfg = big_env_cfg(family, mode == "meta_pd")
    step = CS.ControlStep(topo, cfg, m, (2, 2))
    qpos, qvel, act, tb = _inputs(frames, step.act_dim, 1)
    qo, vo = _host(step, qpos, qvel, act, tb, 0.7)
    qr, vr = CS.control_step_reference(topo, cfg, m, qpos, qvel, act, tb,
                                       0.7, (2, 2))
    assert np.all(np.isfinite(qo)) and np.all(np.isfinite(vo))
    close(qo, qr, 1e-5)
    close(vo, vr, 1e-3)
    # the step moved the state
    assert np.abs(qo - qpos.numpy()).max() > 1e-4


@pytest.mark.parametrize("family", BIG_FAMILIES)
def test_host_split_equals_host_k1d(trees, family):
    """K2 on a big tree: host head + tail equal host K1d at (2, 2) bit for
    bit, and the head's state and Xp / Xf match the plain head (float32,
    relative to each matrix's largest entry: 1e-3)."""
    _needs_cxx()
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    _, topo, m, frames = trees[family]
    cfg = big_env_cfg(family, True)
    split = K2.ControlStepSplit(topo, cfg, m, 2)
    k1d = CS.ControlStep(topo, cfg, m, (2, 2))
    qpos, qvel, act, tb = _inputs(frames, split.act_dim, 2)
    X = np.zeros((B, 2, topo.nv, topo.nv), np.float32)
    qh, vh = _host(split, qpos, qvel, act, tb, part="head", X=X)
    q2, v2 = _host(split, torch.tensor(qh), torch.tensor(vh), act, tb,
                   part="tail", X=X)
    q1, v1 = _host(k1d, qpos, qvel, act, tb)
    assert np.array_equal(q1, q2) and np.array_equal(v1, v2)
    qhr, vhr, Xr = K2.head_reference(topo, cfg, m, qpos, qvel, act, tb, 1.0,
                                     2)
    close(qh, qhr, 1e-5)
    close(vh, vhr, 1e-3)
    scale = Xr.abs().amax((2, 3), keepdim=True).numpy()
    assert np.all(np.abs(X - Xr.numpy()) / scale <= 1e-3)


@pytest.mark.parametrize("family,mode", [("smplh", "plain_pd"),
                                         ("masterfoot", "meta_pd")])
def test_plain_chain_matches_jax(trees, family, mode):
    """The port's plain chain at (2, 2) vs the JAX package's XLA chain
    (uhc_tpu.physics.solver.make_do_simulation, PCG-2) on the JAX-built
    tree: qpos 1e-5, qvel 1e-3 (one gain mode per tree: each JAX compile
    of a big tree takes seconds)."""
    from uhc_tpu.physics import solver as JS
    from uhc_tpu_torch.physics import control_step as CS

    (jt, jm, _), topo, m, frames = trees[family]
    cfg = big_env_cfg(family, mode == "meta_pd")
    step = CS.ControlStep(topo, cfg, m, (2, 2))
    ins = _inputs(frames, step.act_dim, 3)
    sim = jax.jit(JS.make_do_simulation(jt, jax_cfg(cfg), 2))
    qj, vj = sim(jm, *[jnp.asarray(x.numpy()) for x in ins], 1.0)
    qt, vt = step(*ins, 1.0)             # CPU tensors: the plain version
    close(qj, qt, 1e-5)
    close(vj, vt, 1e-3)


@pytest.mark.parametrize("family", BIG_FAMILIES)
def test_pack_tables_for_big_trees(trees, family):
    """The tables fit the host build of the tree's size; the schedule and
    flags close the int table; SMPL-H's 159 actions (189 with meta-PD) fit
    the big build's 256 columns; a library on a big tree is refused."""
    _needs_cxx()
    from uhc_tpu_torch.csrc import build
    from uhc_tpu_torch.physics import control_step as CS

    _, topo, m, _ = trees[family]
    cfg = big_env_cfg(family, True)
    P, I = CS.pack_tables(topo, cfg, m, (2, 2))
    lay = build.layout(build.load_host_library(topo.nbody))
    assert (lay["nbody"], lay["params"], lay["itab"]) == (topo.nbody, P.size,
                                                          I.size)
    assert lay["workspace"] > 0 and lay["maxact"] >= topo.ndof + 6 + 30
    assert I[-8:].tolist() == [1, 1, 1, 1, 2, 2, 15, -1]
    assert sorted(I[2 * topo.nbody:3 * topo.nbody - 1].tolist()) == list(
        range(1, topo.nbody))
    step = CS.ControlStep(topo, cfg, m, (2, 2))
    assert step.act_dim == topo.ndof + 6 + 30
    lib = dataclasses.replace(m, friction=m.friction.expand(3).clone())
    with pytest.raises(NotImplementedError):
        CS.ControlStep(topo, cfg, lib, (2, 2))


def test_flops_and_launch_counters_on_big_trees(trees):
    """control_step_flops counts a big tree (more with contacts, more on
    SMPL-H than on masterfoot without them); the wrapper on CPU tensors
    runs the plain version and counts no launch."""
    from uhc_tpu_torch.physics import control_step as CS

    flops = {}
    for fam in BIG_FAMILIES:
        _, topo, m, frames = trees[fam]
        cfg = big_env_cfg(fam)
        none = [np.zeros((2, topo.nbody), bool)] * 15
        feet = [np.ones((2, topo.nbody), bool)] * 15
        flops[fam] = CS.control_step_flops(topo, cfg, none, (2, 2))
        assert CS.control_step_flops(topo, cfg, feet, (2, 2)) > flops[fam]
        step = CS.ControlStep(topo, cfg, m, (2, 2))
        CS.reset_launches()
        step(*_inputs(frames, step.act_dim, 4, 2), 1.0)
        assert not CS.LAUNCHES
    assert flops["smplh"] > flops["masterfoot"] > 0


def test_wrapper_refuses_other_trees():
    """The kernel is built for euler-joint trees: a ball-joint tree is
    refused (the env refuses tree sizes without a route, see
    test_torch_big_tree.py)."""
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.model import Topology

    cfg = big_env_cfg("smplh")
    ball = Topology(24, tuple([-1] + list(range(23))),
                    tuple(f"b{i}" for i in range(24)), joint_kind="ball")
    with pytest.raises(ValueError, match="euler"):
        CS.pack_tables(ball, cfg, None)


def test_host_library_entry_points_take_no_workspace():
    """The host entry points keep the 24-body signature: the workspace of
    a big tree lives inside the host build."""
    _needs_cxx()
    from uhc_tpu_torch.csrc import build

    lib = build.load_host_library(52)
    assert len(lib.uhc_control_step_host.argtypes) == 12
    assert lib.uhc_control_step_head_host.argtypes[-3] is ctypes.c_int


def test_policy_carried_across_at_smplh_widths(tmp_path_factory, tmp_path,
                                               monkeypatch):
    """A seeded JAX CopycatAgent on SMPL-H (`robot_model smplh`, on the
    stand-in) and the port's agent: the same obs / action widths (1680,
    159), diff weights and expert library; the JAX agent's policy
    parameters, carried into the port by policy_from_numpy, give its
    policy mean within 1e-5 (float32 products summed in another order).
    The JAX agent's reset pose file is not in the repository: it gets the
    port's reset pose (the first library frame) remapped to 24 bodies.
    Two gait clips cut to 10 frames, as in tests/test_torch_big_tree.py."""
    import uhc_tpu.learn.agent as JA
    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu.learn import nets as JN
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import load_motion_file
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.agent import CopycatAgent
    from uhc_tpu_torch.smpl.converter import SMPLConverter
    from uhc_tpu_torch.smpl.fixture_humanoid import (load_fixture_humanoid,
                                                     write_fixture_humanoid)

    clips = str(tmp_path / "clips.pkl")
    seqs = list(load_motion_file(GAIT).items())[:2]
    with open(clips, "wb") as f:
        pickle.dump({k: {"pose_aa": np.asarray(v["pose_aa"])[:10],
                         "trans": np.asarray(v["trans"])[:10]}
                     for k, v in seqs}, f)
    xml = write_fixture_humanoid(str(tmp_path_factory.mktemp("standin")))
    cfg = Config.uhc_implicit()
    cfg = dataclasses.replace(cfg, env=big_env_cfg("smplh"))
    agent = CopycatAgent(cfg, clips, num_envs=4, horizon=4, seed=3,
                         device="cpu", results_dir=str(tmp_path / "port"))
    q24 = SMPLConverter(load_fixture_humanoid()[0], agent.topo,
                        "smplh").qpos_new_2_smpl(agent.aux["neutral_qpos"])
    monkeypatch.setattr(JA, "load_neutral", lambda: (
        jnp.asarray(q24.numpy()), jnp.zeros(75, jnp.float32)))
    jcfg = JConfig(**{**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)},
                      "env": jax_cfg(cfg.env)})
    import uhc_tpu.native.meshtools as native
    monkeypatch.setattr(native, "_load", lambda: None)
    jagent = JA.CopycatAgent(jcfg, clips, num_envs=4, horizon=4, seed=3,
                             model_xml=xml, results_dir=str(tmp_path / "jax"))
    assert (jagent.obs_dim, jagent.action_dim) == (
        agent.obs_dim, agent.action_dim) == (1680, 159)
    assert np.array_equal(np.asarray(jagent.aux["jpos_diffw"]),
                          agent.aux["jpos_diffw"].numpy())
    assert set(jagent.expert_lib) == set(agent.expert_lib)
    for k in jagent.expert_lib:      # as the masterfoot library's bounds
        close(jagent.expert_lib[k], agent.expert_lib[k], 1e-4, 1e-5)
    params = jax.tree_util.tree_map(np.asarray,
                                    jagent.ppo_state.policy_params)
    pol = nets.policy_from_numpy(params, cfg.policy_htype, "cpu")
    x = np.random.default_rng(7).standard_normal(
        (B, agent.obs_dim)).astype(np.float32)
    close(JN.policy_mcp_mean(params, jnp.asarray(x), cfg.policy_htype),
          pol(torch.tensor(x)), 1e-5, 1e-4)
