"""The training slice's pieces, each against its JAX function: running
normalization, the Gaussian log-prob, the adaptive schedules, the
hard-mining sampler, GAE, one PPO update and a short rollout; plus the
rollout's resets and noise, checked on the port alone."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (GAIT, close, env_cfgs, few_threads,
                                jax_cfg, load_both)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("masked", [False, True])
def test_running_norm_update_batch(masked):
    """Chan-merged Welford statistics over five seeded batches, with and
    without a row mask: within 1e-6 relative (float32 sums over ≤ 40
    rows in another order)."""
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu_torch.learn import running_norm as RN

    rng = np.random.default_rng(0)
    rj, rt = JRN.init(7), RN.init(7, "cpu")
    for i in range(5):
        x = (3.0 * rng.standard_normal((8 * (i + 1), 7)) + i).astype(
            np.float32)
        m = rng.random(x.shape[0]) < 0.6 if masked else None
        rj = JRN.update_batch(rj, jnp.asarray(x),
                              None if m is None else jnp.asarray(m))
        rt = RN.update_batch(rt, _t(x), None if m is None else _t(m))
    for k in ("n", "mean", "m2"):
        close(getattr(rj, k), getattr(rt, k), 1e-6, 1e-6)
    x = rng.standard_normal((4, 7)).astype(np.float32)
    close(JRN.normalize(rj, jnp.asarray(x)), RN.normalize(rt, _t(x)), 1e-5)


def test_gaussian_log_prob():
    """Within 1e-5 relative (float32 sum over 9 action dims)."""
    from uhc_tpu.learn import nets as JN
    from uhc_tpu_torch.learn import nets

    rng = np.random.default_rng(1)
    mean, act = (rng.standard_normal((2, 16, 9)).astype(np.float32))
    log_std = (0.3 * rng.standard_normal(9) - 1.5).astype(np.float32)
    close(JN.gaussian_log_prob(mean, log_std, act),
          nets.gaussian_log_prob(_t(mean), _t(log_std), _t(act)), 0.0, 1e-5)


def test_adaptive_params_match_exactly():
    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu_torch.config.config import Config

    sched = dict(adp_iter_cp=(0, 100, 300, 1000),
                 adp_noise_rate_cp=(1.0, 0.5, 0.2),
                 adp_log_std_cp=(-1.0, -2.3),
                 adp_policy_lr_cp=(1e-4, 5e-5, 2e-5, 1e-5))
    cj, ct = JConfig(**sched), Config(**sched)
    for epoch in (0, 1, 50, 99, 100, 101, 250, 300, 640, 999, 1000, 5000):
        assert cj.adaptive_params(epoch) == ct.adaptive_params(epoch)
    assert Config.uhc_implicit().adaptive_params(7) == (1.0, -2.3, 5e-5)


def test_failure_sampler_matches():
    """The same telemetry sequence gives identical logits, restart pools
    and state."""
    from uhc_tpu.data.sampling import FailureFrequencySampler as JS
    from uhc_tpu_torch.data.sampling import FailureFrequencySampler as TS

    sj, st = JS(5, 0.2, 0.75, history=20), TS(5, 0.2, 0.75, history=20)
    rng = np.random.default_rng(2)
    for _ in range(6):
        seq = rng.integers(0, 5, (6, 9))
        dones = rng.random((6, 9)) < 0.3
        pct = np.where(rng.random((6, 9)) < 0.5, 1.0,
                       rng.random((6, 9))).astype(np.float32)
        starts = rng.integers(0, 200, (6, 9))
        sj.update_from_rollout(seq, dones, pct, starts)
        st.update_from_rollout(seq, dones, pct, starts)
        np.testing.assert_array_equal(sj.logits(), st.logits())
        np.testing.assert_array_equal(sj.fail_start_pool(8),
                                      st.fail_start_pool(8))
    assert sj.state_dict() == st.state_dict()


def test_gae_matches():
    """Reverse-time GAE with episode ends and whitening (population std):
    within 1e-5 (float32, 12 steps)."""
    from uhc_tpu.learn.gae import estimate_advantages as jgae
    from uhc_tpu_torch.learn.gae import estimate_advantages

    rng = np.random.default_rng(3)
    T, B = 12, 7
    r = rng.random((T, B)).astype(np.float32)
    m = (rng.random((T, B)) > 0.15).astype(np.float32)
    v = rng.standard_normal((T, B)).astype(np.float32)
    boot = rng.standard_normal(B).astype(np.float32)
    aj, rj = jgae(*(jnp.asarray(x) for x in (r, m, v, boot)), 0.95, 0.95)
    at, rt = estimate_advantages(*(_t(x) for x in (r, m, v, boot)), 0.95,
                                 0.95)
    close(aj, at, 1e-5)
    close(rj, rt, 1e-5)


D, A, N = 12, 5, 48


def _small_nets(seed):
    from uhc_tpu_torch.learn import nets

    gen = torch.Generator().manual_seed(seed)
    pol = nets.policy_mcp_init(D, A, (16, 8), (8, 4), 3, gen, "relu", "cpu")
    val = nets.value_init(D, (16, 8), gen, "relu", "cpu")
    return pol, val


def _ppo_batch(seed):
    rng = np.random.default_rng(seed)
    return {"states": rng.standard_normal((N, D)).astype(np.float32),
            "actions": (0.3 * rng.standard_normal((N, A))).astype(
                np.float32),
            # large enough that the policy gradient's norm passes the clip
            "advantages": (10.0 * rng.standard_normal(N)).astype(np.float32),
            "returns": (2.0 + rng.standard_normal(N)).astype(np.float32),
            "exps": (rng.random(N) < 0.7).astype(np.float32)}


def test_ppo_update_matches_jax():
    """One PPO update (3 passes, one minibatch holding the whole batch, so
    the JAX shuffle only reorders rows inside it) from the same params:
    losses within 1e-5 relative; params within 2·lr per Adam step (a step
    moves a parameter by about lr in the sign of its gradient, which a
    near-zero gradient can flip)."""
    _ppo_update_case(fix_std=True)


def test_ppo_update_matches_jax_trainable_std():
    """The same update with fix_std=False: the log-std trains with its own
    Adam at the policy's rate and the clip takes one norm over the
    policy's and the log-std's gradients. The log-std is held within
    1e-2·lr per Adam step, and moved: its gradient sums over every row, so
    it is far from zero and both sides take the same steps (they agree
    bit for bit here); a step of the wrong sign lands 2·lr away. The
    losses get 1e-5 absolute on top of 1e-5 relative: the policy loss is
    a mean of terms of size |adv| ≈ 10 that cancel to 0.34, and with the
    std moving too the params' 1e-7 rounding gaps reach it at 1.1e-5
    relative."""
    _ppo_update_case(fix_std=False, loss_atol=1e-5)


def test_ppo_update_matches_jax_trainable_std_sgd():
    """The trainable-std update under plain SGD for the policy and the
    log-std. An Adam step is about lr in the sign of its gradient whatever
    the gradient's scale, so under Adam the clip's scale hardly shows in
    the log-std; an SGD step is lr·g, so a log-std left out of the joint
    clip moves by its unclipped gradient (2.2e-3 away from JAX here,
    against the bound of 1e-2·lr per step, 1.5e-6). The policy params are
    held at the same bound; the losses and the value net as above."""
    _ppo_update_case(fix_std=False, loss_atol=1e-5, sgd=True)


def _ppo_update_case(fix_std, loss_atol=0.0, sgd=False):
    import optax

    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn.ppo import PPOState, make_ppo_update
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.ppo import policy_loss, ppo_update

    lr_p, lr_v, epochs = 5e-5, 3e-4, 3
    pol, val = _small_nets(4)
    pp, vp = nets.policy_to_numpy(pol), nets.value_to_numpy(val)
    log_std = np.full(A, -2.3, np.float32)
    batch = _ppo_batch(5)
    tb = {k: _t(v) for k, v in batch.items()}

    # the policy gradient's norm exceeds the clip, so the clip is exercised
    flp = nets.gaussian_log_prob(pol(tb["states"]), _t(log_std),
                                 tb["actions"]).detach()
    policy_loss(pol, _t(log_std), tb["states"], tb["actions"],
                tb["advantages"], flp, tb["exps"], 0.2).backward()
    assert torch.sqrt(sum((p.grad ** 2).sum()
                          for p in pol.parameters())) > 40.0
    pol.zero_grad(set_to_none=True)

    popt, vopt = (optax.sgd if sgd else optax.adam)(lr_p), optax.adam(lr_v)
    lopt = None if fix_std else (optax.sgd if sgd else optax.adam)(lr_p)
    update = make_ppo_update(
        lambda p, x: JN.policy_mcp_mean(p, x, "relu"),
        lambda p, x: JN.value_apply(p, x, "relu"), popt, vopt, 0.2, epochs,
        N, fix_std=fix_std, log_std_optimizer=lopt)
    jstate, jlog_std, jstats = update(
        PPOState(pp, vp, popt.init(pp), vopt.init(vp),
                 None if fix_std else lopt.init(jnp.asarray(log_std))),
        jnp.asarray(log_std), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))

    t_log_std = _t(log_std)
    log_std_opt = None
    if not fix_std:
        t_log_std.requires_grad_()
        log_std_opt = (torch.optim.SGD if sgd else torch.optim.Adam)(
            [t_log_std], lr=lr_p)
    popt_t = (torch.optim.SGD if sgd else torch.optim.Adam)(
        pol.parameters(), lr=lr_p)
    stats = ppo_update(pol, val, popt_t,
                       torch.optim.Adam(val.parameters(), lr=lr_v),
                       t_log_std, tb, torch.Generator().manual_seed(0),
                       0.2, epochs, N, log_std_opt=log_std_opt)
    for k in ("value_loss", "policy_loss"):
        close(jstats[k], stats[k], loss_atol, 1e-5)
    assert stats["value_loss"] < stats["value_loss_before"]
    for tree_j, tree_t, lr in ((jstate.policy_params,
                                nets.policy_to_numpy(pol), lr_p),
                               (jstate.value_params,
                                nets.value_to_numpy(val), lr_v)):
        # an SGD step has no sign flip: its gap is rounding of lr·g
        tol = (1e-2 if sgd and lr == lr_p else 2) * lr * epochs
        for a, b in zip(jax.tree.leaves(tree_j), jax.tree.leaves(tree_t)):
            close(a, b, tol)
        # and the update moved them
        assert any(np.abs(np.asarray(a) - np.asarray(b)).max() > 0
                   for a, b in zip(jax.tree.leaves(tree_t),
                                   jax.tree.leaves(pp if lr == lr_p
                                                   else vp)))
    close(jlog_std, t_log_std, 1e-2 * lr_p * epochs)
    moved = np.abs(t_log_std.detach().numpy() - log_std).max()
    assert moved == 0.0 if fix_std else moved > 0.5 * lr_p


def test_ppo_minibatches_partition_the_permutation():
    """Each pass splits its permutation into N // mb consecutive
    minibatches, dropping the remainder; a batch smaller than the
    minibatch is one minibatch of all rows."""
    from uhc_tpu_torch.learn.ppo import minibatches

    perm = torch.randperm(23, generator=torch.Generator().manual_seed(0))
    mbs = minibatches(23, 5, perm)
    assert [len(m) for m in mbs] == [5] * 4
    assert torch.equal(torch.cat(mbs), perm[:20])
    assert len(set(torch.cat(mbs).tolist())) == 20
    one = minibatches(4, 8, perm[:4])
    assert len(one) == 1 and torch.equal(one[0], perm[:4])


def test_ppo_update_steps_per_minibatch():
    """A smaller minibatch: 3 passes × (48 // 20 = 2) minibatches = 6 Adam
    steps on each net."""
    from uhc_tpu_torch.learn.ppo import ppo_update

    pol, val = _small_nets(6)
    popt = torch.optim.Adam(pol.parameters(), lr=1e-4)
    vopt = torch.optim.Adam(val.parameters(), lr=1e-4)
    ppo_update(pol, val, popt, vopt, torch.full((A,), -2.3),
               {k: _t(v) for k, v in _ppo_batch(7).items()},
               torch.Generator().manual_seed(1), 0.2, 3, 20)
    for opt in (popt, vopt):
        steps = {int(s["step"]) for s in opt.state.values()}
        assert steps == {6}


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------

FRAMES, B, HORIZON = 30, 4, 3


@pytest.fixture(scope="module")
def rollout_setup(tmp_path_factory):
    from uhc_tpu.data.dataset import build_expert_library as jax_build
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file,
                                            neutral_from_library)
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.constants import default_diff_weights

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    cfg = env_cfgs()["plain_pd"]
    jpw, bdw = default_diff_weights()
    jlib, _ = jax_build(jt, jm, jax_load_motion(GAIT), max_len=FRAMES)
    m = model_from_numpy(tm, "cpu")
    lib, _ = build_expert_library(tt, m, load_motion_file(GAIT),
                                  max_len=FRAMES)
    nq, nv = neutral_from_library(lib)
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    aux_j = {"neutral_qpos": jnp.asarray(nq.numpy()),
             "neutral_qvel": jnp.zeros(75), "jpos_diffw": jnp.asarray(jpw),
             "body_diffw": jnp.asarray(bdw)}
    pol = nets.policy_mcp_init(H.obs_dim(tt, cfg), 75, (64, 32), (16, 8), 3,
                               torch.Generator().manual_seed(8), "relu",
                               "cpu")
    return dict(jt=jt, jm=jm, jlib=jlib, aux_j=aux_j, tt=tt, m=m, lib=lib,
                aux=aux, cfg=cfg, pol=pol)


def _jax_rollout(s, seq, start, rs):
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn.rollout import make_rollout_fn as jax_rollout
    from uhc_tpu_torch.learn import nets

    jcfg = jax_cfg(s["cfg"])
    if "jax_fn" not in s:
        s["jax_fn"] = jax.jit(jax_rollout(
            s["jt"], jcfg, lambda p, x: JN.policy_mcp_mean(p, x, "relu"),
            HORIZON, fused_model=None))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states = jax.vmap(lambda k, q, st: JH.env_reset(
        s["jt"], s["jm"], jcfg, k, q, s["jlib"], s["aux_j"]["neutral_qpos"],
        s["aux_j"]["neutral_qvel"], start_ind=st, train=False))(
        keys, jnp.asarray(seq, jnp.int32), jnp.asarray(start, jnp.int32))
    return s["jax_fn"](s["jm"], s["jlib"], s["aux_j"],
                       nets.policy_to_numpy(s["pol"]), jnp.full(75, -2.3),
                       rs, states, jax.random.PRNGKey(1), 0.0, 1.0,
                       jnp.zeros(6))


def _unit_stats(dev_or_jax):
    """Running stats worth two observations of unit variance, so that the
    first batches' normalization divides by no near-zero std."""
    if dev_or_jax == "jax":
        from uhc_tpu.learn import running_norm as JRN

        return JRN.RunningStats(jnp.asarray(2.0), jnp.zeros(784),
                                jnp.ones(784))
    from uhc_tpu_torch.learn import running_norm as RN

    return RN.RunningStats(torch.tensor(2.0), torch.zeros(784),
                           torch.ones(784))


def _port_rollout(s, seq, start, rs, gen=None, noise_rate=0.0,
                  seq_logits=None, states=None):
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn.rollout import make_rollout_fn

    if states is None:
        states = H.env_reset(s["tt"], s["m"], s["cfg"], torch.tensor(seq),
                             s["lib"], s["aux"]["neutral_qpos"],
                             s["aux"]["neutral_qvel"],
                             start_ind=torch.tensor(start), train=False)
    fn = make_rollout_fn(s["tt"], s["cfg"], s["pol"], HORIZON)
    return fn(s["m"], s["lib"], s["aux"], torch.full((75,), -2.3), rs,
              states, gen or torch.Generator().manual_seed(0), noise_rate,
              1.0, torch.zeros(6) if seq_logits is None else seq_logits)


def test_rollout_matches_jax(rollout_setup):
    """Three steps of 4 envs with the mean action (noise_rate 0, exps all
    0) from the same eval-mode resets and unit running stats, plain PCG-5
    physics on both sides, no episode ending: normalized observations,
    rewards, masks, running stats and final qpos against
    uhc_tpu.learn.rollout. Bounds come from the reference's own
    sensitivity: started with its running mean 1e-6 away, the JAX rollout
    moves by 2.1e-4 in final qpos, 3.6e-5 in observations, 7.1e-3 in the
    last (bootstrap) observation and 7.7e-7 in rewards (printed below); the
    port is held to about five times those."""
    s = rollout_setup
    seq, start = np.array([0, 1, 3, 5]), np.array([0, 4, 9, 2])
    rj0 = _unit_stats("jax")
    sj, rsj, trj, lastj = _jax_rollout(s, seq, start, rj0)
    sj2, _, trj2, lastj2 = _jax_rollout(
        s, seq, start, type(rj0)(rj0.n, rj0.mean + 1e-6, rj0.m2))
    st, rst, trt, lastt = _port_rollout(s, seq, start, _unit_stats("port"))
    for name, a, b, c in (("qpos", sj.qpos, sj2.qpos, st.qpos),
                          ("obs", trj.states, trj2.states, trt.states),
                          ("last obs", lastj, lastj2, lastt),
                          ("reward", trj.rewards, trj2.rewards, trt.rewards)):
        a, b = np.asarray(a), np.asarray(b)
        print(f"rollout {name}: JAX vs itself (mean + 1e-6) "
              f"{np.abs(a - b).max():.3e}, port vs JAX "
              f"{np.abs(a - c.numpy()).max():.3e}")

    assert not np.asarray(trj.dones).any() and not trt.dones.any()
    assert np.all(np.asarray(trj.exps) == 0) and torch.all(trt.exps == 0)
    np.testing.assert_array_equal(np.asarray(trj.masks), trt.masks.numpy())
    assert np.abs(np.asarray(sj.qpos) - np.asarray(sj2.qpos)).max() > 1e-5
    close(trj.states, trt.states, 2e-4)
    close(lastj, lastt, 4e-2)
    close(trj.actions, trt.actions, 1e-4)
    close(trj.rewards, trt.rewards, 5e-6)
    close(sj.qpos, st.qpos, 1e-3)
    assert float(rsj.n) == float(rst.n) == 2 + B * HORIZON
    close(rsj.mean, rst.mean, 1e-4, 1e-5)
    close(rsj.m2, rst.m2, 1e-3, 1e-4)


def test_rollout_resets_follow_logits_and_noise(rollout_setup):
    """From fresh (all done) states every reset lands on the one clip a
    one-hot seq_logits allows; noise_rate=1 makes every step stochastic
    (exps all 1), with actions off the mean."""
    from uhc_tpu_torch.learn import running_norm as RN
    from uhc_tpu_torch.learn.rollout import init_env_states

    s = rollout_setup
    gen = torch.Generator().manual_seed(3)
    fresh = init_env_states(s["tt"], s["cfg"], s["m"], s["lib"], s["aux"],
                            gen, 16)
    assert fresh.done.all()
    logits = torch.full((6,), -1e9)
    logits[4] = 0.0
    _, _, traj, _ = _port_rollout(s, None, None, RN.init(784, "cpu"), gen,
                                  1.0, logits, fresh)
    assert torch.all(traj.seq_idx[0] == 4)
    assert torch.all(traj.exps == 1.0)
    assert torch.all(traj.start_inds[0] < FRAMES - s["cfg"].t_min)


def test_precision_restarts_stay_near_failures(rollout_setup):
    """precision_freq=1 with a recorded failure start c restarts in
    [max(c - 20 - t_min, 0), min(c + 20, len - t_min)); an empty pool
    (-1) falls back to the uniform window start."""
    from uhc_tpu_torch.learn.rollout import reset_like

    from uhc_tpu_torch.envs.humanoid_im import PER_SEQ_KEYS

    s = rollout_setup
    # the clips held at their last frame out to 200 frames
    lib = {k: v if k in PER_SEQ_KEYS else torch.cat(
        [v, v[:, -1:].expand((-1, 200 - FRAMES) + v.shape[2:])], 1)
        for k, v in s["lib"].items()}
    lib["len"] = torch.full((6,), 200, dtype=torch.int64)
    pool = torch.full((6, 8), -1, dtype=torch.int64)
    pool[2] = 90
    logits = torch.full((6,), -1e9)
    logits[2] = 0.0
    gen = torch.Generator().manual_seed(5)
    st = reset_like(s["tt"], s["cfg"], s["m"], lib, s["aux"], 256, gen,
                    logits, pool, 1.0)
    t_min = s["cfg"].t_min
    assert st.start_ind.min() >= 90 - 20 - t_min
    assert st.start_ind.max() < 110
    logits = torch.zeros(6)
    logits[2] = -1e9
    st = reset_like(s["tt"], s["cfg"], s["m"], lib, s["aux"], 256, gen,
                    logits, pool, 1.0)
    assert st.start_ind.max() >= 110 and st.start_ind.max() < 200 - t_min
