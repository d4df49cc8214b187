"""The fifth slice: explicit residual force control and per-joint meta-PD
on the 24-body stand-in with a shared model. The engine pieces, action
layout, rewards, plain chain, a short rollout and the policy carried
across, each against the JAX package; K1f's CUDA source built as host C++
against its plain version; the routing against the JAX package's; and (on
a card only) K1f itself."""
import dataclasses
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as C
from test_torch_helpers import (GAIT, close, few_threads, jax_cfg,
                                load_both, states)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

B = 6
# K1f's five modes (chip_smoke.py `k1f_modes`)
MODES = ("explicit", "explicit_height", "explicit_ground", "meta_joint",
         "explicit_meta_joint")


def cfgs():
    """{mode: the port's EnvConfig} of the five modes and uhc_implicit."""
    from uhc_tpu_torch.config.config import Config

    return {**C.k1f_modes(), "uhc_implicit": Config.uhc_implicit().env}


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from uhc_tpu.data.dataset import build_expert_library as jax_build
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")
    jlib, _ = jax_build(jt, jm, jax_load_motion(GAIT), max_len=30)
    lib, _ = build_expert_library(tt, m, load_motion_file(GAIT), max_len=30)
    return dict(jt=jt, jm=jm, jlib=jlib, tt=tt, m=m, lib=lib,
                frames=lib["qpos"].numpy(), cfgs=cfgs())


def _inputs(s, cfg, seed, n=B, lowered=2):
    """Clip-frame states (every `lowered`-th env 2 cm lower, so that the
    ground gate has contacts to read) and seeded actions with 0.05 more
    on the explicit wrench columns, as numpy float32."""
    from uhc_tpu_torch.physics import solver as S

    rng = np.random.default_rng(seed)
    qpos, qvel, tb = states(s["frames"], rng, n)
    qpos[::lowered, 2] -= 0.02
    nd, vf, meta = S.action_dims(s["tt"], cfg)
    act = (0.02 * rng.standard_normal((n, nd + vf + meta))).astype(
        np.float32)
    if S.explicit_rfc(cfg):
        act[:, nd:nd + vf] += 0.05 * rng.standard_normal((n, vf)).astype(
            np.float32)
    return qpos, qvel, act, tb


def test_engine_pieces_match_jax(setup):
    """project_vf_cp, prep_explicit_vf (one and two slots per body, with
    and without hull projection) and vf_contact_gate ("height",
    "ground") vs uhc_tpu.physics.engine, per env through vmap: contact
    points within 1e-6, gates equal; force and torque within 1e-6 once
    divided by residual_force_scale (100): XLA sums two slots' scaled
    forces as (v₁ + v₂)·s, so forces near 100 differ by a float32 ulp
    of the summands (7.6e-6)."""
    from uhc_tpu.physics import engine as JE
    from uhc_tpu_torch.physics import engine as E

    s = setup
    jt, jm, tt, m = s["jt"], s["jm"], s["tt"], s["m"]
    ex = s["cfgs"]["explicit"]
    rng = np.random.default_rng(0)
    cp = (0.3 * rng.standard_normal((B, 24, 3))).astype(np.float32)
    close(jax.vmap(lambda c: JE.project_vf_cp(jm, c))(jnp.asarray(cp)),
          E.project_vf_cp(m, torch.tensor(cp)[:, :, None])[:, :, 0], 1e-6)
    moved = 0
    for num_each in (1, 2):
        for proj in (False, True):
            cfg = dataclasses.replace(ex, residual_force_bodies_num=num_each,
                                      residual_contact_projection=proj)
            vf = (0.3 * rng.standard_normal((B, 9 * 24 * num_each))).astype(
                np.float32)
            want = jax.vmap(lambda v: JE.prep_explicit_vf(
                jm, jax_cfg(cfg), v, 24))(jnp.asarray(vf))
            got = E.prep_explicit_vf(m, cfg, torch.tensor(vf), 24)
            assert got.shape == (B, 24, 9)
            close(want[..., :3], got[..., :3], 1e-6)
            scale = cfg.residual_force_scale
            close(want[..., 3:] / scale, got[..., 3:] / scale, 1e-6)
            if proj:
                moved += int((E.prep_explicit_vf(
                    m, dataclasses.replace(cfg,
                                           residual_contact_projection=False),
                    torch.tensor(vf), 24) != got).any())
    assert moved == 2           # the projection moved some contact points
    qpos, _, _ = states(s["frames"], rng, B)
    qpos[::2, 2] -= 0.02
    kin_j = jax.vmap(lambda q: JE.fk(jt, jm, q))(jnp.asarray(qpos))
    kin_t = E.fk(tt, m, torch.tensor(qpos))
    for mode in ("height", "ground"):
        want = jax.vmap(lambda k: JE.vf_contact_gate(jm, k, mode))(kin_j)
        got = E.vf_contact_gate(m, kin_t, mode)
        assert np.array_equal(np.asarray(want), got.numpy())
        assert 0 < got.sum() < got.numel()


def test_action_dims_and_configs_match_jax(setup):
    """action_dims against uhc_tpu.envs.humanoid_im.action_dims: explicit
    285 = 69 + 9·24, meta_joint 213 = 69 + 6 + 2·69, uhc_implicit 75;
    explicit and meta-PD together 315, two slots per body 501. The YAML
    configs the CLIs reach (`--cfg explicit`, `--cfg meta_joint`) read
    through either package's Config.from_yaml into the dicts chip_smoke
    builds in code."""
    import os

    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.config import config as C
    from uhc_tpu_torch.physics import solver as S

    s = setup
    want = {"explicit": 285, "meta_joint": 213, "uhc_implicit": 75,
            "explicit_meta_joint": 423}
    extra = {"explicit_meta_pd": dataclasses.replace(
        s["cfgs"]["explicit"], meta_pd=True),
        "explicit_two_slots": dataclasses.replace(
        s["cfgs"]["explicit"], residual_force_bodies_num=2)}
    want.update(explicit_meta_pd=315, explicit_two_slots=501)
    for name, cfg in {**s["cfgs"], **extra}.items():
        dims = S.action_dims(s["tt"], cfg)
        assert dims == tuple(JH.action_dims(s["jt"], jax_cfg(cfg))), name
        if name in want:
            assert sum(dims) == want[name], name
    for name, d in (("explicit", C.EXPLICIT), ("meta_joint", C.META_JOINT)):
        port = C.Config.named(name)
        assert port == C.Config.from_dict(name, d)
        assert name not in C.PRESETS
        jcfg = JConfig.from_yaml(name, search_dirs=(os.path.dirname(
            C.__file__),))
        assert jcfg.env == jax_cfg(port.env)
        assert jcfg.policy_hsize == port.policy_hsize == (512, 256)
    with pytest.raises(ValueError, match="no_such_config"):
        C.Config.named("no_such_config")


@pytest.mark.parametrize("reward", ["world_rfc_explicit",
                                    "world_rfc_explicit_mul"])
def test_explicit_rewards_match_jax(setup, reward):
    """world_rfc_explicit[_mul] and their five terms vs the JAX functions,
    within 1e-5 relative (float32 exponentials of sums over 24 bodies),
    on states where some envs' windows have run past the clip's end (the
    velocity term zeroes the expert there)."""
    import uhc_tpu.rewards.reward_function as JR
    from uhc_tpu.smpl.constants import default_diff_weights
    from test_torch_env import _states
    from uhc_tpu_torch.rewards import reward_function as R

    s = setup
    cfg = s["cfgs"]["explicit"]
    tup = (s["jt"], s["jm"], s["jlib"], s["tt"], s["m"], s["lib"])
    jst, port = _states(tup, 4)
    past = np.asarray([0, 25, 0, 28, 0, 0])
    jst = dataclasses.replace(jst, start_ind=jst.start_ind + past)
    port = dataclasses.replace(port, start_ind=port.start_ind
                               + torch.tensor(past))
    assert ((port.start_ind + port.cur_t)
            >= s["lib"]["len"][port.seq_idx]).any()
    jpw, bdw = default_diff_weights()
    aux_j = {"jpos_diffw": jnp.asarray(jpw), "body_diffw": jnp.asarray(bdw)}
    aux_t = {"jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    act = _inputs(s, cfg, 5)[2]
    jfn = getattr(JR, reward)
    rj, tj = jax.vmap(lambda st, a: jfn(s["jt"], s["jm"], jax_cfg(cfg), st,
                                        a, s["jlib"], aux_j))(
        jst, jnp.asarray(act))
    rt, tt_ = R.get_reward_fn(reward)(s["tt"], s["m"], cfg, port,
                                      torch.tensor(act), s["lib"], aux_t)
    close(rj, rt, 0.0, 1e-5)
    close(tj, tt_, 1e-7, 1e-5)
    assert float(np.asarray(tj)[:, 4].min()) < 0.99   # the vf term reads


@pytest.mark.parametrize("mode", MODES)
def test_plain_chain_matches_jax(setup, mode):
    """One control step of the port's plain chain at PCG (2, 2) vs
    uhc_tpu.physics.solver.make_do_simulation at PCG-2 (the same
    schedule: only float reassociation differs), qpos ≤ 1e-5, qvel ≤ 1e-3
    (the kernel-vs-XLA bounds of tests/test_fused_split.py)."""
    from uhc_tpu.physics import solver as JS
    from uhc_tpu_torch.physics import control_step as CS

    s = setup
    cfg = s["cfgs"][mode]
    qpos, qvel, act, tb = _inputs(s, cfg, 2)
    sim = jax.jit(JS.make_do_simulation(s["jt"], jax_cfg(cfg), 2))
    qj, vj = sim(s["jm"], *(jnp.asarray(x) for x in (qpos, qvel, act, tb)),
                 1.0)
    qt, vt = CS.control_step_reference(
        s["tt"], cfg, s["m"], *(torch.tensor(x) for x in (qpos, qvel, act,
                                                          tb)), 1.0, (2, 2))
    close(qj, qt, 1e-5)
    close(vj, vt, 1e-3)


def _run_host_k1f(step, qpos, qvel, act, tb, vfx, gains, rfc_rate=1.0):
    from uhc_tpu_torch.csrc import build

    lib = build.load_host_library()
    assert build.layout(lib)["itab"] == step.itab.size
    P = np.ascontiguousarray(step.params, np.float32)
    I = np.ascontiguousarray(step.itab, np.int32)
    ins = [np.ascontiguousarray(np.asarray(x), np.float32)
           for x in (qpos, qvel, act, tb)]
    ops = [None if x is None else np.ascontiguousarray(x.numpy())
           for x in (vfx, gains)]
    qo, vo = np.zeros_like(ins[0]), np.zeros_like(ins[1])
    assert lib.uhc_control_step_f_host(
        P.ctypes.data, None, I.ctypes.data, *[x.ctypes.data for x in ins],
        qo.ctypes.data, vo.ctypes.data,
        *[None if x is None else x.ctypes.data for x in ops],
        qpos.shape[0], act.shape[1], rfc_rate) == 0
    return qo, vo


@pytest.mark.parametrize("mode", MODES)
def test_k1f_source_on_host_matches_plain_version(setup, mode):
    """K1f's arithmetic (csrc/control_step.cu `control_step_env<true>`
    built as host C++) vs control_step_reference at schedule (1, 2),
    qpos ≤ 1e-5, qvel ≤ 1e-3, on states with ground contacts; and
    zeroing each of the mode's terms (the wrench columns; the per-joint
    scale columns, scales 1) moves the host build's qpos by more than
    1e-5, so neither term is dropped."""
    _needs_cxx()
    from uhc_tpu_torch.physics import control_step as CS

    s = setup
    cfg = s["cfgs"][mode]
    step = CS.ControlStep(s["tt"], cfg, s["m"], (1, 2))
    assert step.k1f
    qpos, qvel, act, tb = (torch.tensor(x) for x in _inputs(s, cfg, 3))
    vfx, gains = CS.k1f_operands(s["tt"], cfg, s["m"], act)
    qo, vo = _run_host_k1f(step, qpos, qvel, act, tb, vfx, gains, 0.7)
    qr, vr = CS.control_step_reference(s["tt"], cfg, s["m"], qpos, qvel,
                                       act, tb, 0.7, (1, 2))
    assert np.abs(qo - qr.numpy()).max() <= 1e-5
    assert np.abs(vo - vr.numpy()).max() <= 1e-3
    zeroed = C.k1f_zeroed(s["tt"], cfg, act)
    assert set(zeroed) == ({"wrench"} if "explicit" in mode else set()) | (
        {"per_dof_gains"} if "meta_joint" in mode else set())
    for term, act0 in zeroed.items():
        q0, _ = _run_host_k1f(step, qpos, qvel, act0, tb,
                              *CS.k1f_operands(s["tt"], cfg, s["m"], act0))
        assert np.abs(q0 - qo).max() > 1e-5, term


def test_k1f_tables_and_operands(setup):
    """The RFC and gain flags of the int table (control_step.cu RFC_*,
    GAINS_*), the K1f operands' shapes and the columns kept in shared
    memory; the wrapper's checks of the operands."""
    from uhc_tpu_torch.physics import control_step as CS

    s = setup
    flags = {"explicit": (2, 0), "explicit_height": (3, 0),
             "explicit_ground": (4, 0), "meta_joint": (1, 2),
             "explicit_meta_joint": (2, 2), "uhc_implicit": (1, 0)}
    for mode, (rfc, gains) in flags.items():
        cfg = s["cfgs"][mode]
        P, I = CS.pack_tables(s["tt"], cfg, s["m"], (1, 2))
        assert I.size == 235 and I[-7].item() == rfc and \
            I[-5].item() == gains, mode
        step = CS.ControlStep(s["tt"], cfg, s["m"], (1, 2))
        assert step.k1f == (mode != "uhc_implicit")
        assert CS.kept_action_columns(s["tt"], cfg) <= 128
        qpos, qvel, act, tb = (torch.tensor(x) for x in _inputs(s, cfg, 4,
                                                                 n=3))
        vfx, g = CS.k1f_operands(s["tt"], cfg, s["m"], act)
        assert (vfx is None) == ("explicit" not in mode)
        assert (g is None) == ("meta_joint" not in mode)
        if g is not None:
            assert g.shape == (3, 2, 75) and bool((g[:, :, :6] == 1).all())
        if not step.k1f:
            continue
        assert step.check_inputs(qpos, qvel, act, tb, (vfx, g)) == 3
        with pytest.raises(ValueError, match="missing"):
            step.check_inputs(qpos, qvel, act, tb, (None, None))
    ex = s["cfgs"]["explicit"]
    assert CS.kept_action_columns(
        s["tt"], dataclasses.replace(ex, meta_pd=True)) == 69 + 30


def test_routing_matches_jax(setup, monkeypatch):
    """make_env_step_batched against the JAX package's own routing
    (uhc_tpu/envs/humanoid_im.py:853-951, read by replacing its kernel
    builders with recorders) for each K1f mode, on a shared model and on
    a model library, with UHC_TPU_LANE unset and 0: the lane kernel is
    K1f (`ControlStep` with k1f, over the library with seq_idx for
    per-joint meta-PD), the v2 kernel never, and the JAX package's XLA
    chain is the port's plain chain (`step.kernel` None).
    ControlStepSplit refuses either term, and ControlStep explicit RFC
    over a library."""
    import uhc_tpu.physics.pallas_lane as JPL
    import uhc_tpu.physics.pallas_substep as JPS
    import uhc_tpu.physics.solver as JS
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit

    s = setup
    seen = []
    monkeypatch.setattr(JPL, "make_fused_do_simulation_lane",
                        lambda *a, **k: seen.append("lane"))
    monkeypatch.setattr(JPS, "make_fused_do_simulation",
                        lambda *a, **k: seen.append("v2"))
    monkeypatch.setattr(JS, "make_do_simulation",
                        lambda *a, **k: seen.append("xla"))
    jlibm = dataclasses.replace(
        s["jm"], body_pos=jnp.broadcast_to(s["jm"].body_pos, (3, 24, 3)))
    libm = dataclasses.replace(
        s["m"], body_pos=s["m"].body_pos.expand(3, -1, -1).clone())
    routes = {}
    for mode in MODES:
        cfg = s["cfgs"][mode]
        for library in (False, True):
            for lane in ("1", "0"):
                monkeypatch.setenv("UHC_TPU_LANE", lane)
                seen.clear()
                JH.make_env_step_batched(s["jt"], jax_cfg(cfg),
                                         fused_model=jlibm if library
                                         else s["jm"])
                k = H.make_env_step_batched(
                    s["tt"], cfg, fused_model=libm if library
                    else s["m"]).kernel
                port = ("xla" if k is None else "v2" if isinstance(
                    k, ControlStepSplit) else "lane")
                assert seen == [port], (mode, library, lane)
                if k is not None:
                    assert k.k1f and k.pcg_iters == (1, 2)
                    assert (k.num_models is not None) == library
                routes[mode, library, lane] = port
    assert routes["meta_joint", True, "1"] == "lane"
    assert routes["explicit", True, "1"] == "xla"
    with pytest.raises(ValueError, match="head/tail"):
        ControlStepSplit(s["tt"], s["cfgs"]["meta_joint"], s["m"])
    with pytest.raises(ValueError, match="library"):
        CS.ControlStep(s["tt"], s["cfgs"]["explicit"], libm)


def test_big_trees_refuse_k1f(setup, tmp_path, monkeypatch):
    """SMPL-H and masterfoot with explicit RFC or per-joint meta-PD, which
    the port once refused: the wrapper and the env step on the lane route
    now give K1f at (2, 2), the env step under UHC_TPU_LANE_BIG=0 the
    plain chain (the JAX package's XLA fallback), and a model library on
    a big tree is still refused (tests/test_torch_k1f_big.py holds the
    routing against the JAX package's own)."""
    from test_torch_helpers import BIG_FAMILIES, big_env_cfg, big_trees
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.model import model_from_numpy

    trees = big_trees(tmp_path)
    for fam in BIG_FAMILIES:
        _, (topo, mnp, _) = trees[fam]
        m = model_from_numpy(mnp, "cpu")
        for terms in ({"residual_force_mode": "explicit"},
                      {"meta_pd_joint": True}):
            cfg = dataclasses.replace(big_env_cfg(fam), **terms)
            step = CS.ControlStep(topo, cfg, m, (2, 2))
            assert step.k1f and step.num_models is None
            monkeypatch.delenv("UHC_TPU_LANE_BIG", raising=False)
            k = H.make_env_step_batched(topo, cfg, fused_model=m).kernel
            assert type(k) is CS.ControlStep and k.k1f
            assert k.pcg_iters == (2, 2) and k.topo.nbody == topo.nbody
            monkeypatch.setenv("UHC_TPU_LANE_BIG", "0")
            assert H.make_env_step_batched(topo, cfg,
                                           fused_model=m).kernel is None
            lib = dataclasses.replace(m, friction=m.friction.expand(
                3).clone())
            with pytest.raises(NotImplementedError, match="library"):
                CS.ControlStep(topo, cfg, lib, (2, 2))


def test_explicit_rollout_matches_jax(setup):
    """Three steps of 4 envs under the explicit config with the mean
    action of a small seeded MCP policy (noise_rate 0), from the same
    eval-mode resets and unit running stats, plain PCG-5 physics on both
    sides, no episode ending: normalized observations, actions, rewards,
    masks, running stats and final qpos against uhc_tpu.learn.rollout,
    within the bounds of tests/test_torch_train.py
    test_rollout_matches_jax."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu.learn.rollout import make_rollout_fn as jax_rollout
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.data.dataset import neutral_from_library
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn import running_norm as RN
    from uhc_tpu_torch.learn.rollout import make_rollout_fn

    s = setup
    cfg, n, T = s["cfgs"]["explicit"], 4, 3
    A = sum(H.action_dims(s["tt"], cfg))
    jcfg = jax_cfg(cfg)
    pol = nets.policy_mcp_init(H.obs_dim(s["tt"], cfg), A, (64, 32), (16, 8),
                               3, torch.Generator().manual_seed(8), "relu",
                               "cpu")
    jpw, bdw = default_diff_weights()
    nq, nv = neutral_from_library(s["lib"])
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    aux_j = {"neutral_qpos": jnp.asarray(nq.numpy()),
             "neutral_qvel": jnp.zeros(75), "jpos_diffw": jnp.asarray(jpw),
             "body_diffw": jnp.asarray(bdw)}
    seq, start = np.array([0, 1, 3, 5]), np.array([0, 4, 9, 2])
    fn_j = jax.jit(jax_rollout(
        s["jt"], jcfg, lambda p, x: JN.policy_mcp_mean(p, x, "relu"), T,
        fused_model=None))

    def run_jax(mean_shift):
        keys = jax.random.split(jax.random.PRNGKey(0), n)
        st = jax.vmap(lambda k, q, b: JH.env_reset(
            s["jt"], s["jm"], jcfg, k, q, s["jlib"], aux_j["neutral_qpos"],
            aux_j["neutral_qvel"], start_ind=b, train=False))(
            keys, jnp.asarray(seq, jnp.int32), jnp.asarray(start, jnp.int32))
        rs = JRN.RunningStats(jnp.asarray(2.0), jnp.zeros(784) + mean_shift,
                              jnp.ones(784))
        return fn_j(s["jm"], s["jlib"], aux_j, nets.policy_to_numpy(pol),
                    jnp.full(A, -2.3), rs, st, jax.random.PRNGKey(1), 0.0,
                    1.0, jnp.zeros(6))

    sj, rsj, trj, lastj = run_jax(0.0)
    sj2, _, trj2, lastj2 = run_jax(1e-6)
    st0 = H.env_reset(s["tt"], s["m"], cfg, torch.tensor(seq), s["lib"], nq,
                      nv, start_ind=torch.tensor(start), train=False)
    st, rst, trt, lastt = make_rollout_fn(s["tt"], cfg, pol, T)(
        s["m"], s["lib"], aux, torch.full((A,), -2.3),
        RN.RunningStats(torch.tensor(2.0), torch.zeros(784),
                        torch.ones(784)),
        st0, torch.Generator().manual_seed(0), 0.0, 1.0, torch.zeros(6))
    for name, a, b, c in (("qpos", sj.qpos, sj2.qpos, st.qpos),
                          ("obs", trj.states, trj2.states, trt.states),
                          ("last obs", lastj, lastj2, lastt),
                          ("reward", trj.rewards, trj2.rewards, trt.rewards)):
        a, b = np.asarray(a), np.asarray(b)
        print(f"explicit rollout {name}: JAX vs itself (mean + 1e-6) "
              f"{np.abs(a - b).max():.3e}, port vs JAX "
              f"{np.abs(a - c.numpy()).max():.3e}")
    assert not np.asarray(trj.dones).any() and not trt.dones.any()
    np.testing.assert_array_equal(np.asarray(trj.masks), trt.masks.numpy())
    assert trt.actions.shape[-1] == 285
    close(trj.states, trt.states, 2e-4)
    close(lastj, lastt, 4e-2)
    close(trj.actions, trt.actions, 1e-4)
    close(trj.rewards, trt.rewards, 5e-6)
    close(sj.qpos, st.qpos, 1e-3)
    close(rsj.mean, rst.mean, 1e-4, 1e-5)
    close(rsj.m2, rst.m2, 1e-3, 1e-4)


@pytest.mark.parametrize("name", ["explicit", "meta_joint"])
def test_policy_carried_across_at_k1f_widths(tmp_path_factory, tmp_path,
                                             monkeypatch, name):
    """A seeded JAX CopycatAgent under the config and the port's agent:
    the same obs / action widths (784, 285 or 213); the JAX agent's
    policy and value parameters, carried into the port by
    policy_from_numpy / value_from_numpy, give its policy mean and value
    within 1e-5 (float32 products summed in another order). Two gait
    clips cut to 10 frames; the JAX agent gets the port's reset pose (its
    own file is not in the repository)."""
    import uhc_tpu.learn.agent as JA
    import uhc_tpu.native.meshtools as native
    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu.learn import nets as JN
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import load_motion_file
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.agent import CopycatAgent
    from uhc_tpu_torch.smpl.fixture_humanoid import write_fixture_humanoid

    clips = str(tmp_path / "clips.pkl")
    seqs = list(load_motion_file(GAIT).items())[:2]
    with open(clips, "wb") as f:
        pickle.dump({k: {"pose_aa": np.asarray(v["pose_aa"])[:10],
                         "trans": np.asarray(v["trans"])[:10]}
                     for k, v in seqs}, f)
    xml = write_fixture_humanoid(str(tmp_path_factory.mktemp("standin")))
    cfg = Config.named(name)
    agent = CopycatAgent(cfg, clips, num_envs=4, horizon=4, seed=3,
                         device="cpu", results_dir=str(tmp_path / "port"))
    monkeypatch.setattr(JA, "load_neutral", lambda: (
        jnp.asarray(agent.aux["neutral_qpos"].numpy()),
        jnp.zeros(75, jnp.float32)))
    monkeypatch.setattr(native, "_load", lambda: None)
    jcfg = JConfig(**{**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)},
                      "env": jax_cfg(cfg.env)})
    jagent = JA.CopycatAgent(jcfg, clips, num_envs=4, horizon=4, seed=3,
                             model_xml=xml, results_dir=str(tmp_path / "jax"))
    assert (jagent.obs_dim, jagent.action_dim) == (
        agent.obs_dim, agent.action_dim) == (
        784, {"explicit": 285, "meta_joint": 213}[name])
    params = jax.tree_util.tree_map(np.asarray,
                                    jagent.ppo_state.policy_params)
    vparams = jax.tree_util.tree_map(np.asarray,
                                     jagent.ppo_state.value_params)
    pol = nets.policy_from_numpy(params, cfg.policy_htype, "cpu")
    val = nets.value_from_numpy(vparams, cfg.value_htype, "cpu")
    x = np.random.default_rng(7).standard_normal(
        (B, agent.obs_dim)).astype(np.float32)
    close(JN.policy_mcp_mean(params, jnp.asarray(x), cfg.policy_htype),
          pol(torch.tensor(x)), 1e-5, 1e-4)
    close(JN.value_apply(vparams, jnp.asarray(x), cfg.value_htype),
          val(torch.tensor(x)), 1e-5, 1e-4)


def test_gate_holds_edge_envs_to_the_side_they_land_on():
    """chip_smoke's `gate` on made-up results of 16 envs: on an edge env
    (the float32 plain version outside the bounds of the float64 one) a
    kernel passes within the bounds of either plain version and fails
    beside both; on every other env it must be within the bounds of
    both."""
    p64 = (torch.zeros(16, 3, dtype=torch.float64),
           torch.zeros(16, 2, dtype=torch.float64))
    p32 = (p64[0].float().clone(), p64[1].float().clone())
    p32[0][3] = 8e-4                          # env 3 is an edge env
    for k3, k5, ok in ((0.0, 0.0, True),      # lands with float64
                       (8e-4, 0.0, True),     # lands with float32
                       (4e-4, 0.0, False),    # beside both
                       (0.0, 3e-5, False)):   # env 5 is no edge env
        out = (p32[0].clone(), p32[1].clone())
        out[0][3], out[0][5] = k3, k5
        errs, fails = C.gate("made-up", out, p32, p64)
        assert errs["edge_envs"] == 1 and (not fails) == ok, (k3, k5, fails)
        assert [e["env"] for e in errs["edge_held_to_plain64"]] == (
            [3] if k3 == 0.0 else [])


@pytest.mark.gpu
def test_k1f_on_card_matches_plain_version(setup):
    """On a CUDA card: K1f in its five modes at B=64 vs its float64 plain
    version (see chip_smoke.py phase k1f, which runs the same check at
    B=256 through its edge-env `gate`), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.model import model_from_numpy, model_to_numpy

    s = setup
    mc = model_from_numpy(model_to_numpy(s["m"]), "cuda")
    m64 = type(mc)(**{f.name: getattr(mc, f.name).double()
                      for f in dataclasses.fields(mc)})
    for mode in MODES:
        cfg = s["cfgs"][mode]
        step = CS.ControlStep(s["tt"], cfg, mc, (1, 2))
        ins = [torch.tensor(x).cuda() for x in _inputs(s, cfg, 7, n=64,
                                                       lowered=4)]
        n0 = CS.LAUNCHES["k1f", 24, False]
        qk, vk = step(*ins, 1.0)
        assert CS.LAUNCHES["k1f", 24, False] == n0 + 1
        q64, v64 = CS.control_step_reference(
            s["tt"], cfg, m64, *[x.double() for x in ins], 1.0, (1, 2))
        assert (qk.double() - q64).abs().max().item() <= 1e-5, mode
        assert (vk.double() - v64).abs().max().item() <= 1e-3, mode
