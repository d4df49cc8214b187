"""The UHM agent (uhc_tpu_torch.learn.agent_uhm) against the JAX package:
the carry-over of the repository's trained kin checkpoint
(results/uhm_1/models/iter_0100.p) and frozen copycat
(results/uhc_implicit/models/iter_best.p) at full width; one rl_update and
one full_update from the same parameters, trajectory, windows and mask;
checkpoints written by either package loaded by the other; the uhm_1
preset against config/uhm_1.yml. The CLIs: tests/test_torch_eval_relive.py.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, few_threads, jax_library

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

GAIT = "sample_data/gait_clips.pkl"
KIN_CKPT = "results/uhm_1/models/iter_0100.p"
CC_CKPT = "results/uhc_implicit/models/iter_best.p"
FRAMES = 12


def small_uhm_dict():
    """uhm_1 at small widths: kin MLP (64, 32), GRU 32, value (64, 32),
    2 optimization epochs."""
    from uhc_tpu_torch.config.config import UHM_1

    return {**UHM_1, "value_hsize": [64, 32], "num_optim_epoch": 2,
            "model_specs": {**UHM_1["model_specs"], "mlp_hsize": [64, 32],
                            "rnn_hdim": 32},
            "policy_specs": {**UHM_1["policy_specs"], "window": 8,
                             "batch": 3}}


def both_agents(tmp_path, monkeypatch, d, cc_checkpoint=None):
    """The JAX UHMAgent on the stand-in (its native mesh toolkit off, as
    the port's stand-in is built; the port's gait library handed to it)
    and the port's, the port's networks carried over from the JAX ones.
    Returns (jax agent, port agent)."""
    import uhc_tpu.learn.agent_uhm as JA
    import uhc_tpu.native.meshtools as native
    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn import kin_net as KN
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.agent_uhm import UHMAgent
    from uhc_tpu_torch.smpl.fixture_humanoid import write_fixture_humanoid

    agent = UHMAgent(Config.from_dict("uhm_small", d), GAIT,
                     cc_checkpoint_path=cc_checkpoint, num_envs=4, horizon=3,
                     max_seq_len=FRAMES, results_dir=str(tmp_path / "port"),
                     device="cpu")
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(JA, "build_expert_library", lambda *a, **k: (
        jax_library(agent.context_lib), list(agent.seq_keys)))
    ja = JA.UHMAgent(JConfig.from_dict("uhm_small", d), GAIT,
                     cc_checkpoint_path=cc_checkpoint, num_envs=4, horizon=3,
                     model_xml=write_fixture_humanoid(str(tmp_path / "xml")),
                     max_seq_len=FRAMES, results_dir=str(tmp_path / "jax"))
    agent.net = KN.kin_net_from_numpy(jax.tree.map(np.asarray, ja.params),
                                      agent.specs, "cpu")
    agent.value = nets.value_from_numpy(
        jax.tree.map(np.asarray, ja.value_params), "relu", "cpu")
    agent._make_optimizers()
    return ja, agent


def tree_close(want, got_tree, atol, rtol=0.0):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got_tree)
    assert [k for k, _ in flat_w] == [k for k, _ in flat_g]
    worst = 0.0
    for (k, a), (_, b) in zip(flat_w, flat_g):
        a, b = np.asarray(a), np.asarray(b)
        close(a, b, atol, rtol)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def test_trained_checkpoints_carry_over(tmp_path):
    """iter_0100.p at full width (GRU 640 → 512, MLP 1152 → 1024 → 512,
    80 actions, value 640 → 512 → 256): the mean action and GRU state of
    8 seeded obs over 3 recurrent steps, and the value, against JAX within
    1e-5; the tree back bit for bit. iter_best.p's frozen copycat through
    both make_cc_policy_fn on seeded copycat obs within 1e-5."""
    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu.learn import kin_net as JKN
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn.agent_uhm import make_cc_policy_fn as jax_cc
    from uhc_tpu_torch.config.config import UHM_1, Config
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.learn import kin_net as KN
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.agent_uhm import kin_net_specs, make_cc_policy_fn

    ck = joblib_compat.load(KIN_CKPT)
    cfg = Config.preset("uhm_1")
    specs = kin_net_specs(cfg)
    net = KN.kin_net_from_numpy(ck["params"], specs, "cpu")
    assert tuple(net.action_rnn.w_ih.shape) == (640, 1536)
    jspecs = JKN.KinNetSpecs(**dataclasses.asdict(specs))
    rng = np.random.default_rng(31)
    obs = rng.standard_normal((3, 8, 640)).astype(np.float32)
    h, jh = torch.zeros(8, 512), jnp.zeros((8, 512))
    step = jax.jit(jax.vmap(lambda o, hh: JKN.kin_net_action(
        ck["params"], jspecs, o, hh)))
    with torch.no_grad():
        for o in obs:
            a, h = net(torch.as_tensor(o), h)
            ja, jh = step(jnp.asarray(o), jh)
            close(ja, a.numpy(), 1e-5)
            close(jh, h.numpy(), 1e-5)
    value = nets.value_from_numpy(ck["value_params"], "relu", "cpu")
    with torch.no_grad():
        close(JN.value_apply(ck["value_params"], jnp.asarray(obs[0]), "relu"),
              value(torch.as_tensor(obs[0])).numpy(), 1e-5)
    back = KN.kin_net_to_numpy(net)
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(
            ck["params"]), jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(a, b)

    cc_ck = joblib_compat.load(CC_CKPT)
    cc = make_cc_policy_fn(cc_ck, cfg, "cpu")
    jcc = jax_cc(cc_ck, JConfig.from_dict("uhm_1", UHM_1), 784, 75)
    x = (cc_ck["running_stats"]["mean"] + 2 * rng.standard_normal(
        (8, 784))).astype(np.float32)
    with torch.no_grad():
        close(jax.vmap(jcc)(jnp.asarray(x)), cc(torch.as_tensor(x)).numpy(),
              1e-5)


def test_rl_and_full_update_match_jax(tmp_path, monkeypatch):
    """From the same parameters: one rl_update on a seeded trajectory (T=3,
    B=4, one episode end) and one full_update on the same 3 GT windows of
    8 frames and scheduled-sampling mask, against JAX's jitted updates;
    every parameter after each within 2e-6 (a few float32 ulps of the
    weights: each Adam step moves a weight by at most lr, 5e-5 or 3e-4,
    so a sign flip of a gradient entry would show as 1e-4 and more), the
    supervised loss within 1e-5 relative."""
    from uhc_tpu_torch.learn import kin_net as KN
    from uhc_tpu_torch.learn import nets

    d = small_uhm_dict()
    ja, agent = both_agents(tmp_path, monkeypatch, d)
    rng = np.random.default_rng(32)
    T, B = 3, 4
    traj = {"obs": rng.standard_normal((T, B, 640)).astype(np.float32),
            "action": (0.1 * rng.standard_normal((T, B, 80))).astype(
                np.float32),
            "reward": rng.random((T, B)).astype(np.float32),
            "done": np.zeros((T, B), bool)}
    traj["done"][1, 2] = True
    start = jax.tree.map(np.asarray, ja.params)
    # (the jitted updates donate their inputs: each gets its own copy)
    p, o, vp, vo, _ = ja._rl_update(*jax.tree.map(jnp.copy, (
        ja.params, ja.opt_state, ja.value_params, ja.value_opt_state)),
        jax.tree.map(jnp.asarray, traj), jax.random.PRNGKey(0))
    agent.rl_update({k: torch.as_tensor(v) for k, v in traj.items()})
    moved = tree_close(start, jax.tree.map(np.asarray, p), 1.0)
    assert moved > 1e-6, "the update moved nothing"
    print("rl_update:", tree_close(p, KN.kin_net_to_numpy(agent.net), 2e-6),
          tree_close(vp, nets.value_to_numpy(agent.value), 2e-6))

    lib = agent.context_lib
    seq = torch.tensor([0, 3, 5])
    frames = torch.tensor([0, 2, 4])[:, None] + torch.arange(8)
    w = [lib[k][seq[:, None], frames] for k in ("qpos", "qvel", "wbpos")]
    ss = torch.as_tensor(rng.random((3, 8)) < 0.3)
    p2, _, jloss = ja._full_update(*jax.tree.map(jnp.copy, (p, o)),
                                   *(jnp.asarray(x.numpy())
                                     for x in (*w, ss)))
    loss = agent.full_update_on(*w, ss)
    close(float(jloss), float(loss), 0.0, 1e-5)
    print("full_update:", tree_close(p2, KN.kin_net_to_numpy(agent.net),
                                     2e-6))


def test_checkpoints_load_across_packages(tmp_path, monkeypatch):
    """A port checkpoint loads in JAX's UHMAgent.load_checkpoint_file and a
    JAX one in the port's, bit for bit (params, value params, epoch)."""
    from uhc_tpu_torch.learn import kin_net as KN
    from uhc_tpu_torch.learn import nets

    ja, agent = both_agents(tmp_path, monkeypatch, small_uhm_dict())
    with torch.no_grad():
        for prm in agent.net.parameters():
            prm.add_(0.01)
    path = agent.save_checkpoint(7)
    ja.load_checkpoint_file(path)
    assert ja.epoch == 7
    tree_close(ja.params, KN.kin_net_to_numpy(agent.net), 0.0)
    tree_close(ja.value_params, nets.value_to_numpy(agent.value), 0.0)
    ja.params = jax.tree.map(lambda x: x * 1.5, ja.params)
    ja.epoch = 9
    ja.save_checkpoint(9)
    agent.load_checkpoint_file(ja.checkpoint_path(9))
    assert agent.epoch == 9
    tree_close(ja.params, KN.kin_net_to_numpy(agent.net), 0.0)
    with open(ja.checkpoint_path(9), "rb") as f:
        assert set(pickle.load(f)) == {"params", "value_params", "epoch"}


def test_uhm_1_preset_matches_yaml():
    """Config.preset("uhm_1") equals Config.from_dict of
    yaml.safe_load(config/uhm_1.yml) in every field, and its
    model_specs, policy_specs and data_specs equal the file's; every
    other top-level key of the file is in the preset with the file's
    value but joint_params and body_params (the MJCF's gains and
    smpl.constants' diff weights are read instead)."""
    import yaml

    from uhc_tpu_torch.config.config import UHM_1, Config

    with open(os.path.join("config", "uhm_1.yml")) as f:
        d = yaml.safe_load(f)
    a, b = Config.from_dict("uhm_1", d), Config.preset("uhm_1")
    for f in dataclasses.fields(a):
        if f.name != "cfg_dict":
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert set(d) - set(UHM_1) == {"joint_params", "body_params"}
    assert set(UHM_1) <= set(d)
    for k in UHM_1:
        assert UHM_1[k] == d[k], k
