"""PPO update: clipped surrogate + value regression (PyTorch twin of
uhc_tpu.learn.ppo).

Reference semantics (uhc/khrylib/rl/agents/agent_ppo.py:16 update_policy):
  * log-probs snapshotted before optimization,
  * `num_epochs` passes, each over a fresh permutation of the batch,
  * minibatches of `minibatch_size` rows (the remainder is dropped),
  * per minibatch the value step first, then the policy step,
  * the policy loss sums over rows with exps = 1 and divides by
    max(Σexps, 1),
  * the policy gradient is scaled by min(1, clip / (‖g‖ + 1e-8)),
  * separate Adam optimizers for policy and value,
  * with a trainable exploration std (fix_std=False) its log-std is a
    policy parameter with its own Adam, and the clip takes one global
    norm over the policy's gradient and the log-std's together.

The networks, the log-std and the optimizers are updated in place.

`ppo_update_dist` is the same update over the global batch of W ranks
(learn/data_parallel.py), as the JAX mesh path computes it
(uhc_tpu/learn/ppo.py:11-13): every rank draws the same permutation of
the global rows, each minibatch takes its global rows and a rank computes
the loss terms of those it holds (maybe none), the value loss divides its
local sum by the global minibatch size and the policy loss by the global
max(Σexps, 1), one all_reduce per minibatch sums the value, policy and
log-std gradients, and the clip reads the norm of the summed gradient.
"""
from __future__ import annotations

import torch

from uhc_tpu_torch.learn.nets import gaussian_log_prob


def policy_loss(policy, log_std, s, a, adv, flp, exps, clip_epsilon,
                denom=None):
    """The clipped surrogate summed over rows with exps = 1, over `denom`
    (default max(Σexps, 1) of these rows)."""
    lp = gaussian_log_prob(policy(s), log_std, a)
    ratio = torch.exp(lp - flp)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - clip_epsilon, 1.0 + clip_epsilon) * adv
    if denom is None:
        denom = torch.clamp(exps.sum(), min=1.0)
    return -(torch.minimum(surr1, surr2) * exps).sum() / denom


def value_loss(value, s, ret, n=None):
    """The mean squared error over these rows, or their sum over `n`."""
    err = (value(s) - ret) ** 2
    return err.mean() if n is None else err.sum() / n


def _clip_grads(params, clip):
    """Scale the gradients of `params` by min(1, clip / (‖g‖ + 1e-8)), one
    norm over all of them."""
    with torch.no_grad():
        gnorm = torch.sqrt(sum((p.grad ** 2).sum() for p in params))
        scale = torch.clamp(clip / (gnorm + 1e-8), max=1.0)
        for p in params:
            p.grad.mul_(scale)


def minibatches(N: int, minibatch_size: int, perm):
    """Row indices of each minibatch of one pass: consecutive slices of
    `perm`, the remainder dropped (one batch of N rows when N is
    smaller than the minibatch)."""
    n_mb = max(N // minibatch_size, 1)
    mb = minibatch_size if N >= minibatch_size else N
    return [perm[i * mb:(i + 1) * mb] for i in range(n_mb)]


def ppo_update(policy, value, policy_opt, value_opt, log_std, batch,
               generator: torch.Generator, clip_epsilon: float,
               num_epochs: int, minibatch_size: int,
               policy_grad_clip: float = 40.0, log_std_opt=None) -> dict:
    """One PPO optimization over `batch` {states, actions, advantages,
    returns, exps}; returns the value loss before and after and the policy
    loss after, on the whole batch. With `log_std_opt` (an optimizer over
    `log_std`, a leaf that requires grad) the log-std trains too."""
    s, a = batch["states"], batch["actions"]
    adv, ret, exps = batch["advantages"], batch["returns"], batch["exps"]
    N = s.shape[0]
    with torch.no_grad():
        flp = gaussian_log_prob(policy(s), log_std, a)
        v_before = value_loss(value, s, ret)
    pparams = list(policy.parameters())
    clipped = pparams + ([log_std] if log_std_opt is not None else [])
    for _ in range(num_epochs):
        perm = torch.randperm(N, generator=generator,
                              device=generator.device).to(s.device)
        for idx in minibatches(N, minibatch_size, perm):
            value_opt.zero_grad(set_to_none=True)
            value_loss(value, s[idx], ret[idx]).backward()
            value_opt.step()
            policy_opt.zero_grad(set_to_none=True)
            if log_std_opt is not None:
                log_std_opt.zero_grad(set_to_none=True)
            policy_loss(policy, log_std, s[idx], a[idx], adv[idx], flp[idx],
                        exps[idx], clip_epsilon).backward()
            if policy_grad_clip is not None:
                _clip_grads(clipped, policy_grad_clip)
            policy_opt.step()
            if log_std_opt is not None:
                log_std_opt.step()
    with torch.no_grad():
        return {"value_loss_before": v_before,
                "value_loss": value_loss(value, s, ret),
                "policy_loss": policy_loss(policy, log_std, s, a, adv, flp,
                                           exps, clip_epsilon)}


def global_rows(idx, envs: int, dist):
    """Local rows of the global row indices `idx` that this rank holds.
    The global batch is (T, W·envs) flattened time-major, rank r's envs
    being columns [r·envs, (r+1)·envs); a rank's own batch is (T, envs)."""
    B = envs * dist.world_size
    t, b = idx // B, idx % B
    own = (b // envs) == dist.rank
    return (t * envs + b - dist.rank * envs)[own]


def ppo_update_dist(policy, value, policy_opt, value_opt, log_std, batch,
                    generator: torch.Generator, clip_epsilon: float,
                    num_epochs: int, minibatch_size: int, dist, envs: int,
                    policy_grad_clip: float = 40.0, log_std_opt=None) -> dict:
    """`ppo_update` over the global batch of `dist`'s ranks: `batch` holds
    this rank's rows, (T, envs) flattened, and `generator` is seeded alike
    on every rank. Returns the global losses."""
    s, a = batch["states"], batch["actions"]
    adv, ret, exps = batch["advantages"], batch["returns"], batch["exps"]
    N = s.shape[0] * dist.world_size
    with torch.no_grad():
        flp = gaussian_log_prob(policy(s), log_std, a)
        v_before = dist.all_reduce(
            value_loss(value, s, ret, 1.0).reshape(1))[0] / N
    vparams = list(value.parameters())
    clipped = list(policy.parameters()) + (
        [log_std] if log_std_opt is not None else [])
    synced = vparams + clipped
    for _ in range(num_epochs):
        perm = torch.randperm(N, generator=generator,
                              device=generator.device).to(s.device)
        mbs = minibatches(N, minibatch_size, perm)
        rows = [global_rows(idx, envs, dist) for idx in mbs]
        # every minibatch's global Σexps, one all_reduce a pass
        counts = dist.all_reduce(torch.stack([exps[r].sum() for r in rows]))
        for r, count in zip(rows, counts):
            for opt in (value_opt, policy_opt, log_std_opt):
                if opt is not None:
                    opt.zero_grad(set_to_none=True)
            value_loss(value, s[r], ret[r], len(mbs[0])).backward()
            policy_loss(policy, log_std, s[r], a[r], adv[r], flp[r],
                        exps[r], clip_epsilon,
                        torch.clamp(count, min=1.0)).backward()
            flat = dist.all_reduce(torch.cat([
                (p.grad if p.grad is not None
                 else torch.zeros_like(p)).reshape(-1) for p in synced]))
            at = 0
            for p in synced:
                p.grad = flat[at:at + p.numel()].view_as(p)
                at += p.numel()
            value_opt.step()
            if policy_grad_clip is not None:
                _clip_grads(clipped, policy_grad_clip)
            policy_opt.step()
            if log_std_opt is not None:
                log_std_opt.step()
    with torch.no_grad():
        sums = dist.all_reduce(torch.stack([
            value_loss(value, s, ret, 1.0),
            policy_loss(policy, log_std, s, a, adv, flp, exps, clip_epsilon,
                        1.0), exps.sum()]))
        return {"value_loss_before": v_before, "value_loss": sums[0] / N,
                "policy_loss": sums[1] / torch.clamp(sums[2], min=1.0)}
