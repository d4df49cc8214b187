"""Generalized advantage estimation over (T, B) rollouts (PyTorch twin of
uhc_tpu.learn.gae).

A reverse Python loop over time on batched tensors. Masks are 1 within an
episode and 0 at its last step, so values and advantages never flow across
episode boundaries. The last step bootstraps from V(s_{T+1}) because a
rollout window can cut an episode mid-flight.
"""
from __future__ import annotations

import torch


def estimate_advantages(rewards, masks, values, bootstrap_value, gamma, tau):
    """rewards / masks / values: (T, B); bootstrap_value: (B,).

    Returns (advantages, returns), both (T, B), with the advantages
    whitened over the whole batch (population std, as jnp.std)."""
    prev_value = bootstrap_value
    prev_adv = torch.zeros_like(bootstrap_value)
    advantages = torch.empty_like(rewards)
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * prev_value * masks[t] - values[t]
        prev_adv = delta + gamma * tau * prev_adv * masks[t]
        prev_value = values[t]
        advantages[t] = prev_adv
    returns = values + advantages
    advantages = (advantages - advantages.mean()) / (
        advantages.std(correction=0) + 1e-8)
    return advantages, returns
