"""Modules of the learning stack that no entry point drives, each against
its JAX function: the diagonal Gaussian KL, conjugate gradients, one TRPO
update (make_trpo_update) and the transformer actor over obs v4's
per-body tokens, with weights carried across; and the agent with a
trainable log-std (fix_std=False) for one CPU epoch."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

D, A, N = 12, 5, 64


def _t(x):
    return torch.tensor(np.asarray(x))


def test_gaussian_kl_matches_jax():
    """Within 1e-5 relative (a float32 sum over 7 action dims)."""
    from uhc_tpu.learn import nets as JN
    from uhc_tpu_torch.learn import nets

    rng = np.random.default_rng(0)
    m0, m1 = rng.standard_normal((2, 9, 7)).astype(np.float32)
    s0, s1 = (0.3 * rng.standard_normal((2, 7)) - 1.0).astype(np.float32)
    close(JN.gaussian_kl(m0, s0, m1, s1),
          nets.gaussian_kl(_t(m0), _t(s0), _t(m1), _t(s1)), 1e-6, 1e-5)
    assert torch.equal(nets.gaussian_kl(_t(m0), _t(s0), _t(m0), _t(s0)),
                       torch.zeros(9))


def test_conjugate_gradients_matches_jax():
    """10 CG steps on a 30 × 30 SPD system: within 1e-4 relative of the
    JAX solve (float32, condition number ~100), and a converged system
    (b = 0) stays at zero."""
    from uhc_tpu.learn.trpo import conjugate_gradients as jcg
    from uhc_tpu_torch.learn.trpo import conjugate_gradients

    rng = np.random.default_rng(1)
    q = np.linalg.qr(rng.standard_normal((30, 30)))[0]
    mat = (q * np.linspace(0.1, 10.0, 30)) @ q.T
    mat = mat.astype(np.float32)
    b = rng.standard_normal(30).astype(np.float32)
    xj = jcg(lambda v: jnp.asarray(mat) @ v, jnp.asarray(b))
    xt = conjugate_gradients(lambda v: _t(mat) @ v, _t(b))
    close(xj, xt, 1e-4 * np.abs(np.asarray(xj)).max())
    assert torch.equal(conjugate_gradients(lambda v: _t(mat) @ v,
                                           torch.zeros(30)),
                       torch.zeros(30))


def _trpo_setup(seed):
    from uhc_tpu_torch.learn import nets

    gen = torch.Generator().manual_seed(seed)
    pol = nets.policy_mcp_init(D, A, (16, 8), (8, 4), 3, gen, "relu", "cpu")
    val = nets.value_init(D, (16, 8), gen, "relu", "cpu")
    rng = np.random.default_rng(seed)
    batch = {"states": rng.standard_normal((N, D)).astype(np.float32),
             "actions": (0.3 * rng.standard_normal((N, A))).astype(
                 np.float32),
             "advantages": rng.standard_normal(N).astype(np.float32),
             "returns": (1.0 + rng.standard_normal(N)).astype(np.float32),
             "exps": (rng.random(N) < 0.7).astype(np.float32)}
    return pol, val, batch


@pytest.mark.parametrize("seed", [2, 3])
def test_trpo_update_matches_jax(seed):
    """One TRPO update from the same params and batch as
    uhc_tpu.learn.trpo.make_trpo_update: the same accepted flag; the
    policy's params within 1e-4 of the largest move of the step plus 1e-6
    (CG and the line search in float32 over another order of the flat
    vector; 1.8e-5 measured), the value params within 1e-5 (25 plain
    descent steps), the surrogate loss within 1e-5 relative, and the mean
    KL from the old means to the new within 1e-3 relative of the JAX
    step's (3e-5 measured), under the max-KL radius."""
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn.trpo import make_trpo_update as jmake
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.trpo import make_trpo_update

    pol, val, batch = _trpo_setup(seed)
    pp, vp = nets.policy_to_numpy(pol), nets.value_to_numpy(val)
    log_std = np.full(A, -1.0, np.float32)

    def jmean(p, x):
        return JN.policy_mcp_mean(p, x, "relu")

    jupd = jmake(jmean, lambda p, x: JN.value_apply(p, x, "relu"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jpol, jval, jst = jupd(pp, vp, jnp.asarray(log_std), jb)
    st = make_trpo_update(pol, val)(_t(log_std),
                                    {k: _t(v) for k, v in batch.items()})

    assert bool(jst["trpo_accepted"]) == bool(st["trpo_accepted"])
    assert bool(st["trpo_accepted"])
    close(jst["surr_loss"], st["surr_loss"], 0.0, 1e-5)
    move = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(jpol), jax.tree.leaves(pp)))
    assert move > 0
    for a, b in zip(jax.tree.leaves(jpol),
                    jax.tree.leaves(nets.policy_to_numpy(pol))):
        close(a, b, 1e-4 * move + 1e-6)
    for a, b in zip(jax.tree.leaves(jval),
                    jax.tree.leaves(nets.value_to_numpy(val))):
        close(a, b, 1e-5)
    close(jst["value_loss"], st["value_loss"], 0.0, 1e-5)
    s = jb["states"]
    kl_j = float(jnp.mean(JN.gaussian_kl(jmean(pp, s), log_std,
                                         jmean(jpol, s), log_std)))
    assert 0.0 < kl_j <= 1e-2 * 1.01
    close(kl_j, st["kl"], 0.0, 1e-3)


def test_trpo_rejects_a_step_that_cannot_improve():
    """Zero advantages: no fraction improves the surrogate, so the step is
    refused and the policy keeps its params, as in the JAX update."""
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn.trpo import make_trpo_update as jmake
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.trpo import make_trpo_update

    pol, val, batch = _trpo_setup(4)
    batch["advantages"][:] = 0.0
    pp = nets.policy_to_numpy(pol)
    jupd = jmake(lambda p, x: JN.policy_mcp_mean(p, x, "relu"),
                 lambda p, x: JN.value_apply(p, x, "relu"))
    _, _, jst = jupd(pp, nets.value_to_numpy(val), jnp.full(A, -1.0),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    st = make_trpo_update(pol, val)(torch.full((A,), -1.0),
                                    {k: _t(v) for k, v in batch.items()})
    assert not bool(jst["trpo_accepted"]) and not bool(st["trpo_accepted"])
    for a, b in zip(jax.tree.leaves(pp),
                    jax.tree.leaves(nets.policy_to_numpy(pol))):
        assert np.array_equal(a, b)


# obs v4 on the 24-body tree: 28 global features, 23 tokens of 26
NT, TD, GD = 23, 26, 28


def _jax_transformer(seed):
    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu.learn import nets as JN

    params, fn = JN.make_policy(JConfig(actor_type="transformer"),
                                GD + NT * TD, 75, jax.random.PRNGKey(seed),
                                n_tokens=NT, token_dim=TD)
    params.pop("log_std")
    return params, fn


def test_transformer_forward_matches_jax():
    """The JAX transformer's weights carried into the port: the action
    means on seeded obs-v4-shaped inputs within 1e-5 + 1e-4 relative
    (float32 attention, layer norms and tanh GELU in another order), the
    weights written back bit for bit, and the port's own seeded init at
    the same shapes."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn import nets

    params, fn = _jax_transformer(0)
    # heads carry a 0.01 scale at init: randomize them so the comparison
    # is not of near-zero means
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda x: np.asarray(x), params)
    for k in ("head_tok", "head_glob"):
        params[k]["w"] = (0.2 * rng.standard_normal(
            params[k]["w"].shape)).astype(np.float32)
        params[k]["b"] = (0.1 * rng.standard_normal(
            params[k]["b"].shape)).astype(np.float32)
    obs = rng.standard_normal((5, GD + NT * TD)).astype(np.float32)
    pol = nets.policy_from_numpy(params, device="cpu", n_tokens=NT,
                                 token_dim=TD)
    got = pol(_t(obs))
    want = fn(params, jnp.asarray(obs))
    assert got.shape == (5, 75)
    close(want, got, 1e-5, 1e-4)
    back = nets.policy_to_numpy(pol)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert np.array_equal(a, b)

    own = nets.make_policy(Config(actor_type="transformer"), GD + NT * TD,
                           75, torch.Generator().manual_seed(0), "cpu",
                           n_tokens=NT, token_dim=TD)
    for a, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(nets.policy_to_numpy(own))):
        assert np.shape(a) == np.shape(b)
    with pytest.raises(ValueError, match="n_tokens"):
        nets.make_policy(Config(actor_type="transformer"), 626, 75,
                         torch.Generator().manual_seed(0), "cpu")


def test_transformer_gradient_is_finite_and_matches_jax():
    """The gradient of a Gaussian log-likelihood through the transformer:
    finite, every parameter reached, and within 1e-4 of the largest
    entry + 1e-3 relative of the JAX gradient, leaf by leaf."""
    from uhc_tpu.learn import nets as JN
    from uhc_tpu_torch.learn import nets

    params, fn = _jax_transformer(1)
    params = jax.tree.map(lambda x: np.asarray(x), params)
    rng = np.random.default_rng(6)
    obs = rng.standard_normal((4, GD + NT * TD)).astype(np.float32)
    act = (0.1 * rng.standard_normal((4, 75))).astype(np.float32)
    log_std = np.full(75, -2.3, np.float32)

    def jloss(p):
        return -jnp.mean(JN.gaussian_log_prob(fn(p, obs), log_std, act))

    jg = jax.grad(jloss)(params)
    pol = nets.policy_from_numpy(params, device="cpu", n_tokens=NT,
                                 token_dim=TD)
    loss = -nets.gaussian_log_prob(pol(_t(obs)), _t(log_std),
                                   _t(act)).mean()
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in pol.parameters())
    tg = nets.policy_to_numpy(pol)        # the layout of the grads below
    grads = {id(p): p.grad for p in pol.parameters()}
    names = dict(pol.named_parameters())
    flat_t = [grads[id(names[n])].numpy() for n in names]
    flat_j = []
    for n in names:
        node = jg
        for part in n.split("."):
            node = node[int(part)] if part.isdigit() else node[part]
        flat_j.append(np.asarray(node))
    assert len(flat_t) == len(jax.tree.leaves(tg))
    for a, b in zip(flat_j, flat_t):
        close(a, b, 1e-4 * np.abs(a).max() + 1e-8, 1e-3)


def test_trainable_std_agent_epoch(tmp_path):
    """fix_std=False on the agent, one CPU epoch of 4 envs × 4 steps: the
    log-std leaves the config's value (the schedule does not overwrite
    it), the checkpoint keeps it, and a reload restores it with a fresh
    optimizer of its own."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn.agent import CopycatAgent

    cfg = dataclasses.replace(Config.uhc_implicit(), fix_std=False,
                              policy_hsize=(32, 16), value_hsize=(32, 16),
                              composer_dim=(16, 8), num_primitive=2,
                              num_optim_epoch=2)
    agent = CopycatAgent(cfg, "sample_data/gait_clips.pkl", num_envs=4,
                         horizon=4, max_seq_len=20,
                         results_dir=str(tmp_path), device="cpu")
    assert agent.log_std_opt is not None and agent.log_std.requires_grad
    st = agent.optimize_policy(0)
    assert np.isfinite(st["policy_loss"])
    moved = (agent.log_std.detach() - cfg.log_std).abs().max().item()
    assert moved > 0.0
    agent.save_checkpoint(1)
    saved = agent.log_std.detach().clone()
    agent.load_checkpoint(1)
    assert torch.equal(agent.log_std.detach(), saved)
    assert agent.log_std.requires_grad
    assert agent.log_std_opt.param_groups[0]["params"][0] is agent.log_std
    assert not agent.log_std_opt.state
