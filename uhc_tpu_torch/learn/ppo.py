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
"""
from __future__ import annotations

import torch

from uhc_tpu_torch.learn.nets import gaussian_log_prob


def policy_loss(policy, log_std, s, a, adv, flp, exps, clip_epsilon):
    lp = gaussian_log_prob(policy(s), log_std, a)
    ratio = torch.exp(lp - flp)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - clip_epsilon, 1.0 + clip_epsilon) * adv
    return -(torch.minimum(surr1, surr2) * exps).sum() / torch.clamp(
        exps.sum(), min=1.0)


def value_loss(value, s, ret):
    return ((value(s) - ret) ** 2).mean()


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
                with torch.no_grad():
                    gnorm = torch.sqrt(sum((p.grad ** 2).sum()
                                           for p in clipped))
                    scale = torch.clamp(policy_grad_clip / (gnorm + 1e-8),
                                        max=1.0)
                    for p in clipped:
                        p.grad.mul_(scale)
            policy_opt.step()
            if log_std_opt is not None:
                log_std_opt.step()
    with torch.no_grad():
        return {"value_loss_before": v_before,
                "value_loss": value_loss(value, s, ret),
                "policy_loss": policy_loss(policy, log_std, s, a, adv, flp,
                                           exps, clip_epsilon)}
