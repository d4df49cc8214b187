"""Batched rollout on the device (PyTorch twin of uhc_tpu.learn.rollout).

B humanoids advance lock-step for `horizon` control steps in a Python loop
over time; finished episodes restart in place on a sequence drawn from a
categorical over the motion library (the hard-example mining distribution
is that categorical's logits). Every draw comes from one
`torch.Generator` on the device.

Per-step policy noise as in the reference (agent.py:59-61): with
probability 1 - noise_rate a step uses the mean action and is left out of
the policy gradient (exps = 0).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from uhc_tpu_torch.config.config import EnvConfig
from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.learn import running_norm as RN
from uhc_tpu_torch.physics.model import Model, Topology


class TrajBatch(NamedTuple):
    """(T, B, ...) stacked transitions (khrylib/rl/core/trajbatch.py:4)."""
    states: Any      # normalized observations fed to the policy
    actions: Any
    rewards: Any     # reward stored for GAE (includes the end_reward bonus)
    c_rewards: Any   # raw custom reward
    masks: Any       # 1 - done
    exps: Any        # 1 if stochastic action (policy-gradient rows)
    reward_terms: Any
    dones: Any
    percents: Any    # episode progress at termination
    seq_idx: Any
    fails: Any
    start_inds: Any  # episode window start


def reset_like(topo: Topology, cfg: EnvConfig, model: Model, expert_lib,
               aux, B: int, gen: torch.Generator, seq_logits,
               fail_pool=None, precision_freq: float = 0.0) -> H.EnvState:
    """B fresh training episodes: sequences drawn from `seq_logits`; with
    probability `precision_freq` (precision mode,
    dataset_amass_single.py:222-230) the window starts near a recorded
    failure start c of `fail_pool` (S, P) (-1 = empty), uniformly in
    [max(c-20-t_min, 0), min(c+20, len-t_min)), else uniformly in
    [0, len-t_min)."""
    dev = seq_logits.device
    seq_idx = torch.multinomial(torch.softmax(seq_logits, 0), B,
                                replacement=True, generator=gen)
    start_ind = None
    if fail_pool is not None:
        slot = torch.randint(0, fail_pool.shape[1], (B,), generator=gen,
                             device=dev)
        cand = fail_pool[seq_idx, slot]
        hi = torch.clamp(expert_lib["len"][seq_idx] - cfg.t_min, min=1)
        lo_p = torch.clamp(cand - 20 - cfg.t_min, min=0)
        hi_p = torch.minimum(torch.maximum(cand + 20, lo_p + 1), hi)
        u = torch.rand((3, B), generator=gen, device=dev)
        prec = lo_p + (u[0] * torch.clamp(hi_p - lo_p, min=1)).long()
        uni = (u[1] * hi).long()
        use_prec = (u[2] < precision_freq) & (cand >= 0)
        start_ind = torch.where(use_prec, prec, uni)
    return H.env_reset(topo, model, cfg, seq_idx, expert_lib,
                       aux["neutral_qpos"], aux["neutral_qvel"],
                       start_ind=start_ind, train=True, generator=gen)


def make_rollout_fn(topo: Topology, cfg: EnvConfig, policy_mean_fn: Callable,
                    horizon: int, clip_obs: float = 5.0,
                    fused_model: Model = None, dist=None):
    """Build rollout(model, expert_lib, aux, log_std, rs, env_state, gen,
    noise_rate, rfc_rate, seq_logits, end_reward, fail_pool,
    precision_freq) -> (env_state', rs', TrajBatch, last_obs_norm).

    `policy_mean_fn(normalized_obs) -> mean action`. With `fused_model`
    the physics runs through a control-step kernel
    (`humanoid_im.make_env_step_batched`). Under `dist`
    (learn/data_parallel.Dist) the running statistics merge every rank's
    observations at each step."""
    env_step_batched = H.make_env_step_batched(topo, cfg,
                                               fused_model=fused_model)

    @torch.no_grad()
    def rollout(model, expert_lib, aux, log_std, rs, env_state, gen,
                noise_rate, rfc_rate, seq_logits, end_reward=0.0,
                fail_pool=None, precision_freq=0.0):
        state = env_state
        B = state.qpos.shape[0]
        steps = []
        for _ in range(horizon):
            # finished episodes restart on a freshly drawn sequence
            fresh = reset_like(topo, cfg, model, expert_lib, aux, B, gen,
                               seq_logits, fail_pool, precision_freq)
            state = H.state_where(state.done, fresh, state)

            obs = H.get_obs(topo, model, cfg, state, expert_lib)
            rs = RN.update_batch(rs, obs, dist=dist)
            nobs = RN.normalize(rs, obs, clip_obs)
            mean = policy_mean_fn(nobs)
            noise = torch.exp(log_std) * torch.randn(
                mean.shape, generator=gen, device=mean.device)
            use_mean = torch.rand(B, generator=gen, device=mean.device) < \
                1.0 - noise_rate
            action = torch.where(use_mean[:, None], mean, mean + noise)

            state2, _, reward, terms, done = env_step_batched(
                model, state, action, expert_lib, aux["jpos_diffw"],
                aux["body_diffw"], rfc_rate, train=True)
            # end_reward bonus at episode ends (agent.py:75-76)
            steps.append(TrajBatch(
                states=nobs, actions=action,
                rewards=reward + end_reward * state2.end.to(reward.dtype),
                c_rewards=reward, masks=1.0 - done.to(mean.dtype),
                exps=1.0 - use_mean.to(mean.dtype), reward_terms=terms,
                dones=done, percents=state2.percent,
                seq_idx=state2.seq_idx, fails=state2.fail,
                start_inds=state2.start_ind))
            state = state2
        traj = TrajBatch(*(torch.stack(x) for x in zip(*steps)))
        # bootstrap observation for episodes the window cuts
        last_obs = RN.normalize(
            rs, H.get_obs(topo, model, cfg, state, expert_lib), clip_obs)
        return state, rs, traj, last_obs

    return rollout


def init_env_states(topo: Topology, cfg: EnvConfig, model: Model, expert_lib,
                    aux, gen: torch.Generator, batch: int) -> H.EnvState:
    """`batch` training resets of sequence 0, all marked done so that the
    first rollout step draws their sequences."""
    dev = expert_lib["len"].device
    states = H.env_reset(topo, model, cfg,
                         torch.zeros(batch, dtype=torch.int64, device=dev),
                         expert_lib, aux["neutral_qpos"], aux["neutral_qvel"],
                         train=True, generator=gen)
    return dataclasses.replace(
        states, done=torch.ones(batch, dtype=torch.bool, device=dev))
