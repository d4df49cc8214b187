"""K1f on the big trees: explicit residual force control and per-joint
meta-PD on the 52-body SMPL-H and the 48-body masterfoot built from the
stand-in (`test_torch_helpers.big_trees`), at the big trees' PCG schedule
(2, 2). The port's plain chain against the JAX package's XLA chain, the
routing against the JAX package's own, the action and obs widths, the
explicit wrench and reward on 52 bodies, an epoch of `cli/train --cfg
explicit --robot-model smplh` and of the masterfoot agent under
`meta_joint`, and a seeded JAX agent's policy carried across at width
621 (K1f's host build is held to its plain version in
tests/test_torch_k1f_big_gate.py). Inputs are clip frames of the gait
clips on each tree with seeded noise, made with numpy."""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as C
from test_torch_helpers import (BIG_FAMILIES, GAIT, big_trees, close,
                                few_threads, jax_cfg, states)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

B = 6
MODES = C.K1F_BIG_MODES
# the widths of the slice: (action, kept action columns) per tree and config
WIDTHS = {("smplh", "explicit"): (621, 153),
          ("smplh", "meta_joint"): (465, 159),
          ("masterfoot", "explicit"): (573, 141),
          ("masterfoot", "meta_joint"): (429, 147)}


def cfg_of(family, mode):
    """The port's EnvConfig of a K1f mode on a big tree."""
    return C.on_tree(C.k1f_modes()[mode], family)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{family: ((jax topo, model, converter), port topo, port model,
    the expert library of the gait clips on the tree)}."""
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
        out[fam] = (jax_side, tt, m, lib)
    return out


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A motion file of the first two gait clips, cut to 10 frames."""
    from uhc_tpu_torch.data.dataset import load_motion_file

    seqs = list(load_motion_file(GAIT).items())[:2]
    path = str(tmp_path_factory.mktemp("clips") / "clips.pkl")
    with open(path, "wb") as f:
        pickle.dump({k: {"pose_aa": np.asarray(d["pose_aa"])[:10],
                         "trans": np.asarray(d["trans"])[:10]}
                     for k, d in seqs}, f)
    return path


def _inputs(lib, topo, cfg, seed, n=B, lowered=2):
    """Clip-frame states (every `lowered`-th env 2 cm lower, so that ground
    contacts and the ground gate have something to read) and seeded
    actions with 0.05 more on the explicit wrench columns, as float32
    tensors."""
    from uhc_tpu_torch.physics import solver as S

    rng = np.random.default_rng(seed)
    qpos, qvel, tb = states(lib["qpos"].numpy(), rng, n)
    qpos[::lowered, 2] -= 0.02
    nd, vf, meta = S.action_dims(topo, cfg)
    act = (0.02 * rng.standard_normal((n, nd + vf + meta))).astype(
        np.float32)
    if S.explicit_rfc(cfg):
        act[:, nd:nd + vf] += 0.05 * rng.standard_normal((n, vf)).astype(
            np.float32)
    return [torch.tensor(np.ascontiguousarray(x))
            for x in (qpos, qvel, act, tb)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", BIG_FAMILIES)
def test_plain_chain_matches_jax(trees, family, mode):
    """One control step of uhc_tpu.physics.solver.make_do_simulation at
    PCG-2 on the JAX-built tree vs the port's plain chain at (2, 2), the
    same schedule, on 16 envs (every other one lowered 2 cm), at qpos
    1e-5, qvel 1e-3 (the bounds of tests/test_torch_control_step_big.py
    test_plain_chain_matches_jax) through chip_smoke's `gate_big`: the
    JAX step is held to the port's float32 and float64 plain versions
    per env. Both are float32 implementations, and on lowered masterfoot
    frames two PCG iterations spread float32 results beyond the bounds
    (both miss the float64 step on some envs there, and both agree with
    it at a PCG count that converges), so an env where the JAX step
    misses the float64 one passes only within the port's float32 worst
    miss or by a witness."""
    from uhc_tpu.physics import solver as JS

    (jt, jm, _), topo, m, lib = trees[family]
    cfg = cfg_of(family, mode)
    ins = _inputs(lib, topo, cfg, 3, n=16)
    sim = jax.jit(JS.make_do_simulation(jt, jax_cfg(cfg), 2))
    out = [torch.tensor(np.asarray(x)) for x in sim(
        jm, *[jnp.asarray(x.numpy()) for x in ins], 1.0)]
    plain32, plain64 = C.plain_pair(topo, cfg, m, ins, (2, 2))
    errs, fails = C.gate_big(
        f"JAX {family} {mode}", out, plain32, plain64,
        lambda e: [C.moved_steps(topo, cfg, m, ins, e, dt)
                   for dt in (torch.float64, torch.float32)])
    assert not fails, (fails, errs["kernel_missed_envs"])
    assert errs["sharp_envs"] >= 8
    assert (out[0] - ins[0]).abs().max().item() > 1e-4


def test_routing_matches_jax(trees, monkeypatch):
    """make_env_step_batched on both trees under explicit and meta_joint
    against the JAX package's own routing (uhc_tpu/envs/humanoid_im.py:
    851-950, read by replacing its kernel builders with recorders), with
    UHC_TPU_LANE_BIG unset, 1 and 0: where the JAX package builds the
    lane kernel (at PCG-2 with pcg_vpu_sub) the port takes K1f at (2, 2),
    where it runs XLA the port runs its plain chain; the v2 kernel never.
    A model library on a big tree is refused by the port's wrapper (the
    JAX agent refuses libraries on these trees)."""
    import uhc_tpu.physics.pallas_lane as JPL
    import uhc_tpu.physics.pallas_substep as JPS
    import uhc_tpu.physics.solver as JS
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics import control_step as CS

    seen = []
    monkeypatch.setattr(JPL, "make_fused_do_simulation_lane",
                        lambda *a, **k: seen.append(("lane", k)))
    monkeypatch.setattr(JPS, "make_fused_do_simulation",
                        lambda *a, **k: seen.append(("v2", k)))
    monkeypatch.setattr(JS, "make_do_simulation",
                        lambda *a, **k: seen.append(("xla", k)))
    monkeypatch.delenv("UHC_TPU_LANE", raising=False)
    routes = {}
    for fam in BIG_FAMILIES:
        (jt, jm, _), topo, m, _ = trees[fam]
        for mode in ("explicit", "meta_joint"):
            cfg = cfg_of(fam, mode)
            for lane_big in (None, "1", "0"):
                if lane_big is None:
                    monkeypatch.delenv("UHC_TPU_LANE_BIG", raising=False)
                else:
                    monkeypatch.setenv("UHC_TPU_LANE_BIG", lane_big)
                seen.clear()
                JH.make_env_step_batched(jt, jax_cfg(cfg), fused_model=jm)
                k = H.make_env_step_batched(topo, cfg, fused_model=m).kernel
                (route, kw), = seen
                assert route == ("xla" if k is None else "lane"), (
                    fam, mode, lane_big)
                if k is not None:
                    assert type(k) is CS.ControlStep and k.k1f
                    assert k.pcg_iters == (2, 2) and kw["pcg_iters"] == 2
                    assert kw["pcg_vpu_sub"] and k.num_models is None
                routes[fam, mode, lane_big] = route
        monkeypatch.delenv("UHC_TPU_LANE_BIG")
        lib = dataclasses.replace(m, friction=m.friction.expand(3).clone())
        with pytest.raises(NotImplementedError, match="library"):
            H.make_env_step_batched(topo, cfg_of(fam, "meta_joint"),
                                    fused_model=lib)
    assert {v for (_, _, lb), v in routes.items() if lb != "0"} == {"lane"}
    assert {v for (_, _, lb), v in routes.items() if lb == "0"} == {"xla"}


def test_widths_match_jax(trees):
    """action_dims and obs_dim against uhc_tpu.envs.humanoid_im on both
    trees under explicit and meta_joint (621 / 465 on SMPL-H, 573 / 429
    on masterfoot); the kept action columns fit the big build's shared
    memory (MAXACT 256), with per-substep meta-PD too."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import solver as S

    for fam in BIG_FAMILIES:
        (jt, _, _), topo, _, _ = trees[fam]
        for mode in ("explicit", "meta_joint"):
            cfg = cfg_of(fam, mode)
            dims = S.action_dims(topo, cfg)
            assert dims == tuple(JH.action_dims(jt, jax_cfg(cfg)))
            assert (sum(dims), CS.kept_action_columns(topo, cfg)) == \
                WIDTHS[fam, mode]
            assert H.obs_dim(topo, cfg) == JH.obs_dim(jt, jax_cfg(cfg))
        both = dataclasses.replace(cfg_of(fam, "explicit"), meta_pd=True)
        assert CS.kept_action_columns(topo, both) == topo.ndof + 30 <= 256


def test_explicit_pieces_on_smplh_match_jax(trees):
    """The 52-body explicit wrench (prep_explicit_vf with hull projection)
    and gate, and world_rfc_explicit with its terms, against the JAX
    functions on SMPL-H clip frames (vmapped per env): contact points
    within 1e-6, forces and torques within 1e-6 of residual_force_scale,
    gates equal, rewards within 1e-5 relative (the bounds of
    tests/test_torch_explicit.py on 24 bodies)."""
    import uhc_tpu.rewards.reward_function as JR
    from uhc_tpu.envs.humanoid_im import EnvState as JState
    from uhc_tpu.physics import engine as JE
    from uhc_tpu.smpl.smplh import smplh_diff_weights as jax_w
    from uhc_tpu_torch.envs.humanoid_im import EnvState, get_body_quat
    from uhc_tpu_torch.physics import engine as E
    from uhc_tpu_torch.physics import solver as S
    from uhc_tpu_torch.rewards import reward_function as R

    (jt, jm, _), topo, m, lib = trees["smplh"]
    cfg = cfg_of("smplh", "explicit")
    jcfg = jax_cfg(cfg)
    qpos, qvel, act, _ = _inputs(lib, topo, cfg, 5)
    nd, vf, _ = S.action_dims(topo, cfg)
    assert vf == 9 * 52
    want = jax.vmap(lambda v: JE.prep_explicit_vf(jm, jcfg, v, 52))(
        jnp.asarray(act[:, nd:nd + vf].numpy()))
    got = E.prep_explicit_vf(m, cfg, act[:, nd:nd + vf], 52)
    assert got.shape == (B, 52, 9)
    close(want[..., :3], got[..., :3], 1e-6)
    scale = cfg.residual_force_scale
    close(want[..., 3:] / scale, got[..., 3:] / scale, 1e-6)
    kin_j = jax.vmap(lambda q: JE.fk(jt, jm, q))(jnp.asarray(qpos.numpy()))
    kin_t = E.fk(topo, m, qpos)
    for gate in ("height", "ground"):
        g = E.vf_contact_gate(m, kin_t, gate)
        assert np.array_equal(np.asarray(jax.vmap(
            lambda k: JE.vf_contact_gate(jm, k, gate))(kin_j)), g.numpy())
    # the reward, one step into windows of the clips
    seq = torch.arange(B) % lib["qpos"].shape[0]
    cur = torch.ones(B, dtype=torch.int64)
    start = torch.tensor([0, 2, 4, 1, 3, 5])
    prev = lib["qpos"][seq, start]
    port = EnvState(qpos=qpos, qvel=qvel, prev_qpos=prev, cur_t=cur,
                    start_ind=start, seq_idx=seq,
                    prev_bquat=get_body_quat(prev),
                    done=torch.zeros(B, dtype=torch.bool),
                    fail=torch.zeros(B, dtype=torch.bool),
                    end=torch.zeros(B, dtype=torch.bool),
                    percent=torch.zeros(B))
    i32 = lambda x: jnp.asarray(x.numpy(), jnp.int32)      # noqa: E731
    jst = JState(qpos=jnp.asarray(qpos.numpy()),
                 qvel=jnp.asarray(qvel.numpy()),
                 prev_qpos=jnp.asarray(prev.numpy()), cur_t=i32(cur),
                 start_ind=i32(start), seq_idx=i32(seq),
                 prev_bquat=jnp.asarray(port.prev_bquat.numpy()),
                 done=jnp.zeros(B, bool), fail=jnp.zeros(B, bool),
                 end=jnp.zeros(B, bool), percent=jnp.zeros(B),
                 rng=jnp.zeros((B, 2), jnp.uint32))
    jlib = {k: jnp.asarray(v.numpy()) for k, v in lib.items()}
    jpw, bdw = jax_w()
    aux_j = {"jpos_diffw": jnp.asarray(jpw), "body_diffw": jnp.asarray(bdw)}
    aux_t = {"jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    rj, tj = jax.vmap(lambda st, a: JR.world_rfc_explicit(
        jt, jm, jcfg, st, a, jlib, aux_j))(jst, jnp.asarray(act.numpy()))
    rt, tt_ = R.get_reward_fn("world_rfc_explicit")(topo, m, cfg, port, act,
                                                     lib, aux_t)
    close(rj, rt, 0.0, 1e-5)
    close(tj, tt_, 1e-7, 1e-5)
    assert float(np.asarray(tj)[:, 4].min()) < 0.99    # the vf term reads


def test_cli_train_explicit_smplh_cpu_epoch(clips, tmp_path):
    """`cli/train --cfg explicit --robot-model smplh --device cpu` at a tiny
    size: one epoch with finite stats and a falling value loss at action
    width 621, the checkpoint, which reloads to the same policy, and the
    eval at it over the clips on the 52-body tree."""
    from uhc_tpu_torch.cli import train
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.learn import nets

    out = str(tmp_path / "run")
    agent, hist = train.main([
        "--cfg", "explicit", "--robot-model", "smplh", "--device", "cpu",
        "--motion-file", clips, "--num-envs", "4", "--horizon", "4",
        "--epochs", "1", "--seed", "2", "--results-dir", out])
    assert agent.topo.nbody == 52 and agent.env_cfg.residual_force_mode \
        == "explicit"
    assert (agent.obs_dim, agent.action_dim) == (1680, 621)
    (st,) = hist
    assert all(np.all(np.isfinite(v)) for v in st.values())
    assert st["value_loss"] < st["value_loss_before"]
    ck = joblib_compat.load(agent.checkpoint_path(1))
    pol = nets.policy_from_numpy(ck["policy_params"], agent.cfg.policy_htype,
                                 "cpu")
    x = torch.randn((3, agent.obs_dim), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        assert torch.equal(pol(x), agent.policy(x))
        assert pol(x).shape == (3, 621)
    with open(os.path.join(out, "eval_0001.json")) as f:
        summary = json.load(f)
    assert summary["num_seqs"] == 2 and np.isfinite(summary["mpjpe"])


def test_masterfoot_meta_joint_agent_epoch_on_cpu(clips, tmp_path):
    """The agent with env.masterfoot under meta_joint: 48 bodies, action
    width 429 (the JAX package's), one finite epoch."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.config.config import META_JOINT, Config
    from uhc_tpu_torch.learn.agent import CopycatAgent

    cfg = Config.from_dict("meta_joint", META_JOINT)
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env,
                                                           masterfoot=True))
    agent = CopycatAgent(cfg, clips, num_envs=4, horizon=3, seed=1,
                         device="cpu", results_dir=str(tmp_path))
    assert agent.topo.nbody == 48 and agent.action_dim == 429
    assert agent.action_dim == sum(JH.action_dims(agent.topo,
                                                  jax_cfg(cfg.env)))
    st = agent.optimize_policy(0)
    assert all(np.all(np.isfinite(v)) for v in st.values())


def test_policy_carried_across_at_width_621(tmp_path_factory, tmp_path,
                                            clips, monkeypatch):
    """A seeded JAX CopycatAgent on SMPL-H under the explicit config and
    the port's agent: the same obs / action widths (1680, 621); the JAX
    agent's policy and value parameters, carried into the port by
    policy_from_numpy / value_from_numpy, give its policy mean and value
    within 1e-5 (float32 products summed in another order). The JAX
    agent gets the port's reset pose remapped to 24 bodies (its own file
    is not in the repository)."""
    import uhc_tpu.learn.agent as JA
    import uhc_tpu.native.meshtools as native
    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu.learn import nets as JN
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.agent import CopycatAgent
    from uhc_tpu_torch.smpl.converter import SMPLConverter
    from uhc_tpu_torch.smpl.fixture_humanoid import (load_fixture_humanoid,
                                                     write_fixture_humanoid)

    xml = write_fixture_humanoid(str(tmp_path_factory.mktemp("standin")))
    cfg = Config.named("explicit")
    cfg = dataclasses.replace(cfg, env=cfg_of("smplh", "explicit"))
    agent = CopycatAgent(cfg, clips, num_envs=4, horizon=4, seed=3,
                         device="cpu", results_dir=str(tmp_path / "port"))
    q24 = SMPLConverter(load_fixture_humanoid()[0], agent.topo,
                        "smplh").qpos_new_2_smpl(agent.aux["neutral_qpos"])
    monkeypatch.setattr(JA, "load_neutral", lambda: (
        jnp.asarray(q24.numpy()), jnp.zeros(75, jnp.float32)))
    monkeypatch.setattr(native, "_load", lambda: None)
    jcfg = JConfig(**{**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)},
                      "env": jax_cfg(cfg.env)})
    jagent = JA.CopycatAgent(jcfg, clips, num_envs=4, horizon=4, seed=3,
                             model_xml=xml, results_dir=str(tmp_path / "jax"))
    assert (jagent.obs_dim, jagent.action_dim) == (
        agent.obs_dim, agent.action_dim) == (1680, 621)
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
