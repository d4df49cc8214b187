"""GAE, the PPO loss and its first minibatch steps, and Adam, written out
plainly.

Semantics (the copycat agent's, after the reference implementation
khrylib agent_ppo.update_policy): advantages by GAE over (T, B) with the
bootstrap of the last step masked where its episode ended, whitened over
the whole batch with the population std; per minibatch a value step
(mean squared error) and then a policy step (the clipped surrogate summed
over rows with exps = 1, over max(Σexps, 1)) whose gradient is scaled by
min(1, 40 / (‖g‖ + 1e-8)), each net with its own Adam (torch's defaults:
β = (0.9, 0.999), ε = 1e-8)."""
from __future__ import annotations

import math

import torch

from benchmark.reference import nets as N

BETAS, EPS, GRAD_CLIP = (0.9, 0.999), 1e-8, 40.0


def gae(rewards, masks, values, bootstrap, gamma: float, tau: float):
    """(advantages whitened, returns), both (T, B)."""
    prev_value = torch.where(masks[-1] > 0, bootstrap,
                             torch.zeros_like(bootstrap))
    prev_adv = torch.zeros_like(bootstrap)
    adv = torch.empty_like(rewards)
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * prev_value * masks[t] - values[t]
        prev_adv = delta + gamma * tau * prev_adv * masks[t]
        prev_value = values[t]
        adv[t] = prev_adv
    ret = values + adv
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8), ret


class Adam:
    """torch.optim.Adam's update over a dict of leaves."""

    def __init__(self, params: dict, lr: float):
        self.p, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + EPS
            self.p[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def policy_loss(pol, log_std, mb, flp, clip: float, act: str, mask=None,
                denom=None):
    """The clipped surrogate over minibatch `mb` (rows outside `mask`
    left out), over max(Σexps, 1) or `denom`."""
    lp = N.log_prob(N.mcp_mean(pol, mb["states"], act), log_std,
                    mb["actions"])
    ratio = torch.exp(lp - flp)
    adv, exps = mb["advantages"], mb["exps"]
    if mask is not None:
        exps = exps * mask
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    if denom is None:
        denom = torch.clamp(exps.sum(), min=1.0)
    return -(surr * exps).sum() / denom


def value_loss(val, mb, act: str, mask=None, denom=None):
    err = (N.value(val, mb["states"], act) - mb["returns"]) ** 2
    if mask is None:
        return err.mean()
    return (err * mask).sum() / denom


def ppo_steps(pol0: dict, val0: dict, log_std, minibatches: list, cfg,
              masks=None) -> dict:
    """The first len(minibatches) PPO steps from parameters (pol0, val0):
    {"losses": [(value loss, policy loss) of each step], "grads": the
    first step's gradients as each Adam gets them (the policy's after the
    clip), "params": the parameters after the last step}. `masks`, one
    (mask, value denominator, policy denominator) per minibatch, leave
    rows out of the sums (a fault's rows, or another rank's)."""
    pol = {k: v.detach().clone().requires_grad_() for k, v in pol0.items()}
    val = {k: v.detach().clone().requires_grad_() for k, v in val0.items()}
    opt_p, opt_v = Adam(pol, cfg.policy_lr), Adam(val, cfg.value_lr)
    losses, first = [], None
    with torch.no_grad():
        flps = [N.log_prob(N.mcp_mean(pol0, mb["states"], cfg.policy_htype),
                           log_std, mb["actions"]) for mb in minibatches]
    for k, (mb, flp) in enumerate(zip(minibatches, flps)):
        m, vden, pden = (None, None, None) if masks is None else masks[k]
        vl = value_loss(val, mb, cfg.value_htype, m, vden)
        gv = dict(zip(val, torch.autograd.grad(vl, list(val.values()))))
        opt_v.step(gv)
        pl = policy_loss(pol, log_std, mb, flp, cfg.clip_epsilon,
                         cfg.policy_htype, m, pden)
        gp = dict(zip(pol, torch.autograd.grad(pl, list(pol.values()))))
        with torch.no_grad():
            norm = torch.sqrt(sum((g ** 2).sum() for g in gp.values()))
            scale = torch.clamp(GRAD_CLIP / (norm + 1e-8), max=1.0)
            gp = {k2: g * scale for k2, g in gp.items()}
        opt_p.step(gp)
        losses.append((vl.detach(), pl.detach()))
        if first is None:
            first = {**{"value." + k2: g for k2, g in gv.items()},
                     **{"policy." + k2: g for k2, g in gp.items()}}
    params = {**{"value." + k: v.detach() for k, v in val.items()},
              **{"policy." + k: v.detach() for k, v in pol.items()}}
    return {"losses": losses, "grads": first, "params": params}
