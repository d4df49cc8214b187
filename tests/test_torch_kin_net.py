"""The kinematic network (uhc_tpu_torch.learn.kin_net, the GRU of
learn/nets.py, learn/losses.py) against the JAX package at small widths
(MLP (64, 32), GRU 32) on the stand-in humanoid and the gait clips: the GRU
against gru_apply and torch's nn.GRUCell, the checkpoint layout both ways,
and for model_v 1 and 2 with env_obs off and on: the forward pass, the
autoregressive rollout under a fixed scheduled-sampling mask, the loss and
its gradient against jax.grad."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, few_threads, load_both

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

GAIT = "sample_data/gait_clips.pkl"
T, N = 8, 3
WEIGHTS = {"r_pos_loss": 1.0, "r_rot_loss": 1.0, "p_rot_loss": 1.0,
           "vl_loss": 0.1, "va_loss": 0.1, "ee_loss": 1.0}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")
    lib, _ = build_expert_library(tt, m, load_motion_file(GAIT), max_len=20)
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 6, N)
    start = rng.integers(0, 20 - T, N)
    frames = start[:, None] + np.arange(T)
    win = {k: np.asarray(lib[k][seq[:, None], frames])
           for k in ("qpos", "qvel", "wbpos")}
    ss = rng.random((N, T)) < 0.3
    return dict(jt=jt, jm=jm, tt=tt, m=m, win=win, ss=ss, rng=rng)


def _specs(model_v, env_obs):
    from uhc_tpu.learn import kin_net as JKN
    from uhc_tpu_torch.learn import kin_net as KN

    kw = dict(mlp_hsize=(64, 32), rnn_hdim=32, model_v=model_v,
              env_obs=env_obs, remove_base=True)
    return JKN.KinNetSpecs(**kw), KN.KinNetSpecs(**kw)


def _pair(s, model_v, env_obs, seed=0):
    """JAX parameters from kin_net_init and the port's net carried over."""
    from uhc_tpu.learn import kin_net as JKN
    from uhc_tpu_torch.learn import kin_net as KN

    jspecs, specs = _specs(model_v, env_obs)
    jp = JKN.kin_net_init(jax.random.PRNGKey(seed), s["jt"], jspecs)
    net = KN.kin_net_from_numpy(jax.tree.map(np.asarray, jp), specs, "cpu")
    return jspecs, specs, jp, net


def test_gru_matches_jax_and_grucell():
    """One GRU step vs gru_apply (1e-6) and vs torch's nn.GRUCell with the
    (in, 3H) weights transposed (1e-6): the reset / update / new gate
    order; gru_to_numpy gives the leaves back bit for bit."""
    from uhc_tpu.learn.nets import gru_apply, gru_init
    from uhc_tpu_torch.learn import nets

    p = jax.tree.map(np.asarray, gru_init(jax.random.PRNGKey(1), 12, 7))
    gru = nets.gru_from_numpy(p, "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    h = rng.standard_normal((5, 7)).astype(np.float32)
    with torch.no_grad():
        got = gru(torch.as_tensor(x), torch.as_tensor(h)).numpy()
    close(np.asarray(gru_apply(p, jnp.asarray(x), jnp.asarray(h))), got,
          1e-6)
    cell = torch.nn.GRUCell(12, 7)
    with torch.no_grad():
        for k in ("w_ih", "w_hh"):
            getattr(cell, "weight" + k[1:]).copy_(torch.as_tensor(p[k].T))
        for k in ("b_ih", "b_hh"):
            getattr(cell, "bias" + k[1:]).copy_(torch.as_tensor(p[k]))
        close(cell(torch.as_tensor(x), torch.as_tensor(h)).numpy(), got, 1e-6)
    back = nets.gru_to_numpy(gru)
    for k in nets.GRU_LEAVES:
        np.testing.assert_array_equal(back[k], p[k])
    g = nets.gru_init(12, 7, torch.Generator().manual_seed(0), "cpu")
    lim = 1 / np.sqrt(7)
    assert all(float(getattr(g, k).abs().max()) <= lim
               for k in nets.GRU_LEAVES)


@pytest.mark.parametrize("model_v", [1, 2])
def test_checkpoint_layout_round_trip(setup, model_v):
    """kin_net_to_numpy gives kin_net_init's tree back bit for bit (keys,
    shapes, values); kin_net_init of the port has the same tree shape."""
    from uhc_tpu_torch.learn import kin_net as KN

    jspecs, specs, jp, net = _pair(setup, model_v, False)
    back = KN.kin_net_to_numpy(net)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_j] == [k for k, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    own = KN.kin_net_to_numpy(KN.kin_net_init(
        setup["tt"], specs, torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, back)


def test_kin_net_obs_matches_jax(setup):
    """The reference KinNet.get_obs layout (env_obs off): B=3 window
    starts against the next frames, 1e-5."""
    from uhc_tpu.learn import kin_net as JKN
    from uhc_tpu_torch.learn import kin_net as KN

    s = setup
    jspecs, specs = _specs(1, False)
    q, v = s["win"]["qpos"], s["win"]["qvel"]
    want = jax.jit(jax.vmap(lambda a, b, c: JKN.kin_net_obs(
        s["jt"], s["jm"], jspecs, a, b, c)))(jnp.asarray(q[:, 0]),
                                             jnp.asarray(v[:, 0]),
                                             jnp.asarray(q[:, 1]))
    got = KN.kin_net_obs(s["tt"], s["m"], specs, torch.as_tensor(q[:, 0]),
                         torch.as_tensor(v[:, 0]), torch.as_tensor(q[:, 1]))
    assert got.shape == (N, KN.kin_obs_dim(s["tt"])) == (N, 640)
    close(np.asarray(want), got.numpy(), 1e-5)


@pytest.mark.parametrize("model_v,env_obs", [(1, False), (1, True),
                                             (2, False), (2, True)])
def test_forward_rollout_loss_grad(setup, model_v, env_obs):
    """The same parameters, windows (N=3 × T=8 GT frames) and
    scheduled-sampling mask in both packages: the forward pass on seeded
    obs (1e-5); the rollout's qpos (1e-4), qvel (2e-2: a finite difference
    over 1/30 s of the qpos) and actions (1e-4); the loss (1e-5 relative)
    and every gradient leaf (1e-4 of the leaf's largest entry, 1e-5
    absolute)."""
    from uhc_tpu.learn import kin_net as JKN
    from uhc_tpu_torch.learn import kin_net as KN

    s = setup
    jspecs, specs, jp, net = _pair(s, model_v, env_obs)
    obs = s["rng"].standard_normal((4, 640)).astype(np.float32)
    h = s["rng"].standard_normal((4, 32)).astype(np.float32)
    ja, jh = jax.vmap(lambda o, hh: JKN.kin_net_action(jp, jspecs, o, hh))(
        jnp.asarray(obs), jnp.asarray(h))
    with torch.no_grad():
        ta, th = KN.kin_net_action(net, torch.as_tensor(obs),
                                   torch.as_tensor(h))
    close(np.asarray(ja), ta.numpy(), 1e-5)
    close(np.asarray(jh), th.numpy(), 1e-5)

    w = {k: jnp.asarray(v) for k, v in s["win"].items()}
    ss = jnp.asarray(s["ss"])

    def jax_loss(p):
        def one(qp, qv, wb, m):
            pred = JKN.kin_net_rollout(p, s["jt"], s["jm"], jspecs, qp, qv, m)
            return JKN.kin_net_loss(pred, qp, qv, wb, WEIGHTS)[0], pred
        tot, pred = jax.vmap(one)(w["qpos"], w["qvel"], w["wbpos"], ss)
        return jnp.mean(tot), pred

    (jl, jpred), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jp)
    tw = {k: torch.as_tensor(v) for k, v in s["win"].items()}
    pred = KN.kin_net_rollout(net, s["tt"], s["m"], specs, tw["qpos"],
                              tw["qvel"], torch.as_tensor(s["ss"]))
    total, terms = KN.kin_net_loss(pred, tw["qpos"], tw["qvel"],
                                   tw["wbpos"], WEIGHTS)
    assert set(terms) == set(WEIGHTS)
    loss = total.mean()
    loss.backward()
    close(np.asarray(jpred["qpos"]), pred["qpos"].detach().numpy(), 1e-4)
    close(np.asarray(jpred["qvel"]), pred["qvel"].detach().numpy(), 2e-2)
    close(np.asarray(jpred["action"]), pred["action"].detach().numpy(), 1e-4)
    close(float(jl), float(loss), 0.0, 1e-5)
    grads = {"log_std": net.log_std.grad,
             "action_fc": {k: net.action_fc[k].grad for k in ("w", "b")},
             "action_mlp": [{"w": w_.grad, "b": b_.grad} for w_, b_ in zip(
                 net.action_mlp.ws, net.action_mlp.bs)]}
    if model_v == 1:
        grads["action_rnn"] = {k: getattr(net.action_rnn, k).grad
                               for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    for path, a in jax.tree_util.tree_leaves_with_path(jg):
        b = grads
        for key in path:
            b = b[key.key if hasattr(key, "key") else key.idx]
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        close(a, b, 1e-5 + 1e-4 * float(np.abs(a).max()))
    # teacher forcing pins the rollout to GT
    full = KN.kin_net_rollout(net, s["tt"], s["m"], specs, tw["qpos"],
                              tw["qvel"], torch.ones((N, T), dtype=bool))
    np.testing.assert_array_equal(full["qpos"].detach().numpy(),
                                  s["win"]["qpos"])


def test_losses_match_jax(setup):
    """Every function of learn/losses.py on seeded (5, 76) / (5, 75)
    inputs, 1e-5 relative."""
    from uhc_tpu.learn import losses as JL
    from uhc_tpu_torch.learn import losses as L

    rng = np.random.default_rng(9)
    a, b = (rng.standard_normal((2, 5, 76)).astype(np.float32))
    va, vb = (rng.standard_normal((2, 5, 75)).astype(np.float32))
    w = dict(w_p=0.5, w_vl=0.1, w_va=0.2, w_ee=1.0, w_rp=1.5, w_rr=0.7)
    t = torch.as_tensor
    for name in ("pose_rot_loss", "root_pos_loss", "root_orientation_loss",
                 "end_effector_pos_loss", "position_loss", "action_loss",
                 "pose_loss_masked"):
        close(np.asarray(getattr(JL, name)(jnp.asarray(a), jnp.asarray(b))),
              getattr(L, name)(t(a), t(b)).numpy(), 1e-6, 1e-5)
    for name in ("velocity_distance_loss", "linear_velocity_loss",
                 "angular_velocity_loss"):
        close(np.asarray(getattr(JL, name)(jnp.asarray(va), jnp.asarray(vb))),
              getattr(L, name)(t(va), t(vb)).numpy(), 1e-6, 1e-5)
    for name in ("deep_mimic_loss", "traj_loss"):
        jt_, jterms = getattr(JL, name)(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(va), jnp.asarray(vb), w)
        tt_, terms = getattr(L, name)(t(a), t(b), t(va), t(vb), w)
        close(float(jt_), float(tt_), 1e-6, 1e-5)
        close(np.asarray(jterms), torch.stack(terms).numpy(), 1e-6, 1e-5)


def test_super_net_matches_jax():
    """SuperNet (the MLP-only variant, super_net_specs forcing model_v 2,
    pose_delta and remove_base) carried over from super_net_init: its
    action on seeded obs within 1e-5."""
    from uhc_tpu.learn import kin_net as JKN
    from uhc_tpu_torch.learn import kin_net as KN

    ms = {"mlp_hsize": [64, 32], "mlp_htype": "relu"}
    jspecs, specs = JKN.super_net_specs(ms), KN.super_net_specs(ms)
    assert dataclasses_equal(jspecs, specs)
    jp = JKN.super_net_init(jax.random.PRNGKey(2), 640, jspecs)
    net = KN.super_net_from_numpy(jax.tree.map(np.asarray, jp), specs, "cpu")
    x = np.random.default_rng(7).standard_normal((5, 640)).astype(np.float32)
    with torch.no_grad():
        got = KN.super_net_apply(net, torch.as_tensor(x)).numpy()
    close(np.asarray(JKN.super_net_apply(jp, jspecs, jnp.asarray(x))), got,
          1e-5)
    own = KN.super_net_init(640, specs, torch.Generator().manual_seed(0),
                            "cpu")
    assert own(torch.as_tensor(x)).shape == (5, 80)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)
