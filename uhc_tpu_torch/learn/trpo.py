"""TRPO update (PyTorch twin of uhc_tpu.learn.trpo; the reference's
khrylib agent_trpo).

A natural-gradient policy step: conjugate gradients solve F·x = -g, with
F·v the Hessian-vector product of the mean KL between the batch's old and
new action means (forward-mode over the KL's gradient, plus damping), the
step scaled to the max-KL trust region, then a backtracking line search
over fractions 0.5**k that keeps the first accepted one. The value net is
fitted first by damped gradient descent. The policy's parameters are one
flat vector, evaluated through `torch.func.functional_call`. Every loop
runs a fixed count with masks in place of early exits, so nothing waits
on the host. No entry point calls it, as in the JAX package (the release
configs train with PPO).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call, grad, grad_and_value, jvp

from uhc_tpu_torch.learn.nets import gaussian_kl, gaussian_log_prob


def conjugate_gradients(avp: Callable, b: torch.Tensor, nsteps: int = 10,
                        rdotr_tol: float = 1e-10) -> torch.Tensor:
    """CG on the (damped) curvature operator `avp`, from zero; an
    iteration after the residual's square falls to `rdotr_tol` changes
    nothing."""
    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    rdotr = r @ r
    for _ in range(nsteps):
        go = rdotr > rdotr_tol
        ap = avp(p)
        alpha = rdotr / (p @ ap)
        r_new = r - alpha * ap
        new_rdotr = r_new @ r_new
        x = torch.where(go, x + alpha * p, x)
        p = torch.where(go, r_new + (new_rdotr / rdotr) * p, p)
        r = torch.where(go, r_new, r)
        rdotr = torch.where(go, new_rdotr, rdotr)
    return x


def make_trpo_update(policy: torch.nn.Module, value: torch.nn.Module,
                     max_kl: float = 1e-2, damping: float = 1e-2,
                     max_backtracks: int = 10, accept_ratio: float = 0.1,
                     value_iters: int = 25, value_lr: float = 1e-2,
                     value_weight_decay: float = 1e-3):
    """Returns update(log_std, batch) -> stats, which updates `policy` and
    `value` in place from `batch` {states, actions, advantages, returns,
    exps} of flat (N, ...) tensors. stats: surr_loss (before the step),
    trpo_accepted, value_loss (after the fit) and kl, the mean KL from
    the old action distribution to the new one."""
    names = [n for n, _ in policy.named_parameters()]
    shapes = [p.shape for _, p in policy.named_parameters()]
    sizes = [p.numel() for _, p in policy.named_parameters()]

    def mean_of(flat, s):
        params = {n: t.view(sh) for n, t, sh in
                  zip(names, torch.split(flat, sizes), shapes)}
        return functional_call(policy, params, (s,))

    def update(log_std, batch) -> dict:
        s, a = batch["states"], batch["actions"]
        adv, ret, exps = batch["advantages"], batch["returns"], batch["exps"]
        w = exps / torch.clamp(exps.sum(), min=1.0)
        log_std = log_std.detach()

        # -- value fit (L-BFGS in the reference; damped descent here) -------
        vparams = list(value.parameters())

        def vloss():
            reg = sum((p ** 2).sum() for p in vparams)
            return ((value(s) - ret) ** 2).mean() + value_weight_decay * reg

        for _ in range(value_iters):
            gs = torch.autograd.grad(vloss(), vparams)
            with torch.no_grad():
                for p, g in zip(vparams, gs):
                    p.sub_(value_lr * g)

        # -- natural-gradient policy step ----------------------------------
        flat0 = torch.cat([p.detach().reshape(-1)
                           for p in policy.parameters()])
        with torch.no_grad():
            fixed_mean = mean_of(flat0, s)
            fixed_lp = gaussian_log_prob(fixed_mean, log_std, a)
        inv_var = torch.exp(-2.0 * log_std)

        def surrogate(flat):
            lp = gaussian_log_prob(mean_of(flat, s), log_std, a)
            return (-adv * torch.exp(lp - fixed_lp) * w).sum()

        def mean_kl(flat):
            # KL(old ‖ new) of a fixed-std Gaussian head: ‖Δμ‖²/(2σ²)
            d = mean_of(flat, s) - fixed_mean
            return 0.5 * (d ** 2 * inv_var).sum(-1).mean()

        kl_grad = grad(mean_kl)

        def fvp(v):
            return jvp(kl_grad, (flat0,), (v,))[1] + damping * v

        loss_grad, loss0 = grad_and_value(surrogate)(flat0)
        with torch.no_grad():
            stepdir = conjugate_gradients(fvp, -loss_grad)
            shs = 0.5 * (stepdir @ fvp(stepdir))
            fullstep = stepdir * torch.sqrt(max_kl / torch.clamp(shs,
                                                                 min=1e-12))
            expected = -(loss_grad @ fullstep)
            # backtracking line search: the first fraction whose actual
            # improvement beats accept_ratio of the expected one wins
            found = torch.zeros((), dtype=torch.bool, device=flat0.device)
            best = flat0
            for k in range(max_backtracks):
                frac = 0.5 ** k
                x_new = flat0 + frac * fullstep
                improve = loss0 - surrogate(x_new)
                ok = (improve / torch.clamp(expected * frac, min=1e-12)
                      > accept_ratio) & ~found
                best = torch.where(ok, x_new, best)
                found = found | ok
            torch.nn.utils.vector_to_parameters(best, policy.parameters())
            kl = gaussian_kl(fixed_mean, log_std, mean_of(best, s),
                             log_std).mean()
            return {"surr_loss": loss0, "trpo_accepted": found,
                    "value_loss": vloss(), "kl": kl}

    return update
