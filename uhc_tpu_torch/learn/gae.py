"""Generalized advantage estimation over (T, B) rollouts (PyTorch twin of
uhc_tpu.learn.gae).

A reverse Python loop over time on batched tensors. Masks are 1 within an
episode and 0 at its last step, so values and advantages never flow across
episode boundaries. The last step bootstraps from V(s_{T+1}) because a
rollout window can cut an episode mid-flight.
"""
from __future__ import annotations

import torch

from uhc_tpu_torch.utils.spans import count, span


def estimate_advantages(rewards, masks, values, bootstrap_value, gamma, tau,
                        dist=None):
    """rewards / masks / values: (T, B); bootstrap_value: (B,).

    Returns (advantages, returns), both (T, B), with the advantages
    whitened over the whole batch (population std, as jnp.std). The
    bootstrap of an episode that ended at the last step is masked out;
    it is set to 0 there first, so that a non-finite one (the observation
    of a blown-up state) cannot turn the masked product into NaN. Under
    `dist` (learn/data_parallel.Dist) the whitening takes the global
    batch's mean and population std, every rank's envs together. It
    runs in the tracer's span gae (utils/spans.py)."""
    with span("gae"):
        prev_value = torch.where(masks[-1] > 0, bootstrap_value,
                                 torch.zeros_like(bootstrap_value))
        prev_adv = torch.zeros_like(bootstrap_value)
        advantages = torch.empty_like(rewards)
        for t in reversed(range(rewards.shape[0])):
            delta = rewards[t] + gamma * prev_value * masks[t] - values[t]
            prev_adv = delta + gamma * tau * prev_adv * masks[t]
            prev_value = values[t]
            advantages[t] = prev_adv
        returns = values + advantages
        if dist is None:
            mean, std = advantages.mean(), advantages.std(correction=0)
        else:
            # a tensor copied from the host: on a card the copy waits for
            # the stream
            count("host_sync")
            n = advantages.new_tensor(float(advantages.numel()))
            s = dist.all_reduce(torch.stack([advantages.sum(), n]))
            mean = s[0] / s[1]
            ss = dist.all_reduce(((advantages - mean) ** 2).sum().reshape(1))
            std = torch.sqrt(ss[0] / s[1])
        advantages = (advantages - mean) / (std + 1e-8)
        return advantages, returns
