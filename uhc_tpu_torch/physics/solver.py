"""Batched substep chain with the maintained-inverse solver (PyTorch twin
of uhc_tpu.physics.solver).

Substep 0 of each 30 Hz control step computes exact inverses of A_pd and
A_fd by blocked Cholesky against the identity; every substep then solves
both systems by preconditioned conjugate gradient warm-started from those
inverses, with `(pd_iters, fd_iters)` iterations. `substeps` runs a range
of them: substep 0 alone returns the inverses (the plain version of K2's
head), substeps 1.. take them (its tail). With `precond_bf16` (the plain
version of K2b) the inverses are rounded to bfloat16 as they are made, and
every preconditioner product rounds its vector to bfloat16 first, in the
chain's own dtype otherwise.

Torque control (action_type "torque", the ball family) takes another
route, as in the JAX package (uhc_tpu/envs/humanoid_im.py:905-910): no
maintained inverse and no kernel, each substep one exact solve of the
forward-dynamics system (`torque_substeps`).
"""
from __future__ import annotations

import torch

from uhc_tpu_torch.maths import (heading_quat, quat_inv, quat_mul,
                                 quat_rotate, wrap_to_pi)
from uhc_tpu_torch.physics import engine as E
from uhc_tpu_torch.physics import linalg as LA
from uhc_tpu_torch.physics.model import Model, Topology, model_per_env
from uhc_tpu_torch.utils.consts import const


def exact_inverse(A: torch.Tensor) -> torch.Tensor:
    """(..., n, n) SPD -> inverse via blocked Cholesky vs the identity."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return LA.blocked_cho_solve(LA.blocked_cholesky(A), eye)


def _mv(A, x):
    return torch.matmul(A, x[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Each entry rounded to the nearest bfloat16 (ties to even), kept in
    t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def pcg_solve(A, b, X, iters: int = 5, precond_bf16: bool = False):
    """Preconditioned CG with warm start x₀ = X·b (X ≈ A⁻¹). With
    `precond_bf16` (X holding bfloat16 values) every product with X rounds
    its vector to bfloat16 first (pallas_substep.py `_mv_pre`)."""
    def pre(v):
        return _mv(X, round_bf16(v) if precond_bf16 else v)

    x = pre(b)
    r = b - _mv(A, x)
    z = pre(r)
    p = z
    rz = _dot(r, z)
    for _ in range(iters):
        Ap = _mv(A, p)
        alpha = rz / (_dot(p, Ap) + 1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pre(r)
        rz_new = _dot(r, z)
        beta = rz_new / (rz + 1e-12)
        p = z + beta * p
        rz = rz_new
    return x


def body_vf_dim(cfg) -> int:
    """Per-body explicit-RFC slot: contact point (3) + force (3) [+ torque
    (3)] (uhc_tpu/envs/humanoid_im.py:95 body_vf_dim)."""
    return 6 + (3 if cfg.residual_force_torque else 0)


def explicit_rfc(cfg) -> bool:
    """Explicit residual force control: per-body [cp|f|τ] wrenches."""
    return bool(cfg.residual_force and cfg.residual_force_mode != "implicit")


def per_joint_gains(cfg) -> bool:
    """Per-joint meta-PD: one kp / kd scale per dof for the whole control
    step (meta_pd, the per-substep scales, takes precedence)."""
    return bool(cfg.meta_pd_joint and not cfg.meta_pd)


def vf_gate_mode(cfg):
    """The explicit-RFC contact gate: None, "height" or "ground"
    (humanoid_im.py:1089-1105 rfc_explicit)."""
    if not (explicit_rfc(cfg) and cfg.residual_contact_only):
        return None
    return "ground" if cfg.residual_contact_only_ground else "height"


def action_dims(topo: Topology, cfg):
    """(ndof, vf_dim, meta_dim) of the action vector
    (uhc_tpu/envs/humanoid_im.py:101 action_dims): implicit RFC takes 6
    columns, explicit RFC body_vf_dim per body × residual_force_bodies_num;
    meta-PD 2 · frame_skip, per-joint meta-PD 2 · ndof."""
    ndof = topo.ndof
    vf_dim = 0
    if cfg.residual_force:
        vf_dim = (6 if cfg.residual_force_mode == "implicit"
                  else body_vf_dim(cfg) * topo.nbody
                  * cfg.residual_force_bodies_num)
    meta_dim = (2 * cfg.frame_skip if cfg.meta_pd
                else 2 * ndof if cfg.meta_pd_joint else 0)
    return ndof, vf_dim, meta_dim


def check_supported(cfg) -> None:
    """The ported control step covers plain PD, meta-PD and per-joint
    meta-PD, implicit, explicit or no RFC, position control with action_v
    0/1, and direct torque control."""
    if cfg.action_type not in ("position", "torque"):
        raise ValueError(f"unknown action_type {cfg.action_type!r}")


def gain_scales(cfg, actions: torch.Tensor, ndof: int, vf_dim: int):
    """kp / kd scales, each (B, frame_skip, 1) per substep (meta-PD, or
    ones) or (B, frame_skip, ndof) per dof (per-joint meta-PD, the same
    for every substep; humanoid_im.py:137-140,161-166)."""
    B, fs = actions.shape[0], cfg.frame_skip
    meta = actions[:, ndof + vf_dim:]
    if cfg.meta_pd:
        return (torch.clamp(meta[:, :fs] + 1.0, 0.0, 10.0)[..., None],
                torch.clamp(meta[:, fs:2 * fs] + 1.0, 0.0, 10.0)[..., None])
    if cfg.meta_pd_joint:
        return tuple(torch.clamp(m + 1.0, 0.0, 10.0)[:, None].expand(
            B, fs, ndof) for m in (meta[:, :ndof], meta[:, ndof:2 * ndof]))
    one = actions.new_ones((B, fs, 1))
    return one, one


def implicit_rfc(cfg, qpos, actions, ndof: int, rfc_rate):
    """(B, nv) applied force of implicit RFC (humanoid_im.py:1136
    rfc_implicit): the scaled root wrench, its linear part rotated into
    the world by the heading, clipped; zero without it."""
    qfrc = qpos.new_zeros((qpos.shape[0], ndof + 6))
    if cfg.residual_force and not explicit_rfc(cfg):
        vf = actions[:, ndof:ndof + 6] * (cfg.residual_force_scale
                                          * rfc_rate)
        base_rot = const(tuple(cfg.base_rot), qpos)
        hq = heading_quat(quat_mul(qpos[:, 3:7], quat_inv(base_rot)))
        vf = torch.cat([quat_rotate(hq, vf[:, :3]), vf[:, 3:]], 1)
        qfrc[:, :6] = torch.clamp(vf, -cfg.residual_force_lim,
                                  cfg.residual_force_lim)
    return qfrc


def explicit_wrench(topo: Topology, cfg, model: Model, actions, ndof: int,
                    vf_dim: int):
    """The (B, nb, 9) body-frame [cp|f|τ] wrench of explicit RFC
    (`engine.prep_explicit_vf`), None without it."""
    if not explicit_rfc(cfg):
        return None
    return E.prep_explicit_vf(model, cfg, actions[:, ndof:ndof + vf_dim],
                              topo.nbody)


def do_simulation(topo: Topology, cfg, model: Model, qpos, qvel, actions,
                  target_base, rfc_rate, pcg_iters=(1, 2), trace=None,
                  refresh_at=None, precond_bf16: bool = False,
                  inverses=None):
    """One control step (frame_skip substeps) for a batch of envs; `model`
    is shared or per env (`env_models` of a library by seq_idx).

    `pcg_iters` is an int or a (pd_iters, fd_iters) pair. `refresh_at=k`
    computes the exact inverse pair again at substep k, from that
    substep's systems (the plain version of K1g; tools/solver_variants.py
    `sched_pcg`). `precond_bf16` rounds the preconditioner to bfloat16
    (the plain version of K2b); given `inverses` (Xpd, Xfd) stand in for
    substep 0's. A `trace` list receives each substep's (B, nb)
    ground-contact sets. Torque control runs `torque_substeps`, whatever
    the PCG arguments say (and records no trace)."""
    if cfg.action_type == "torque":
        return torque_substeps(topo, cfg, model, qpos, qvel, actions,
                               rfc_rate)
    return substeps(topo, cfg, model, qpos, qvel, actions, target_base,
                    rfc_rate, pcg_iters, 0, cfg.frame_skip,
                    inverses=inverses, trace=trace, refresh_at=refresh_at,
                    precond_bf16=precond_bf16)[:2]


def substeps(topo: Topology, cfg, model: Model, qpos, qvel, actions,
             target_base, rfc_rate, pcg_iters, start: int, stop: int,
             inverses=None, trace=None, refresh_at=None,
             precond_bf16: bool = False):
    """Substeps [start, stop) of one control step -> (qpos, qvel,
    (Xpd, Xfd)). A range that starts at 0 computes the exact inverses at
    substep 0 unless `inverses` are given in their place (a kernel's own
    preconditioner, for instance); a later start takes them as
    `inverses`. Substep `refresh_at` computes them again. `precond_bf16`
    rounds the inverses to bfloat16 as they are made and every
    preconditioner product's vector (K2b); given inverses must then hold
    bfloat16 values."""
    check_supported(cfg)
    if cfg.action_type == "torque":
        raise ValueError("torque control has no PCG chain: see "
                         "torque_substeps")
    pd_iters, fd_iters = ((pcg_iters, pcg_iters)
                          if isinstance(pcg_iters, int) else pcg_iters)
    ndof, vf_dim, _ = action_dims(topo, cfg)
    kp_scale, kd_scale = gain_scales(cfg, actions, ndof, vf_dim)
    B = qpos.shape[0]
    model = model_per_env(model, B)
    vf_body = explicit_wrench(topo, cfg, model, actions, ndof, vf_dim)
    if start > 0 and inverses is None:
        raise ValueError("the inverses come from substep 0: pass them "
                         "when start > 0")
    Xpd, Xfd = (None, None) if inverses is None else inverses
    for i in range(start, stop):
        if cfg.action_v == 1:
            base = qpos[:, 7:] + wrap_to_pi(target_base - qpos[:, 7:])
        else:
            base = torch.zeros_like(qpos[:, 7:])
        target_pos = base + actions[:, :ndof]
        qfrc = implicit_rfc(cfg, qpos, actions, ndof, rfc_rate)
        kp = model.jkp * kp_scale[:, i]
        kd = model.jkd * kd_scale[:, i]
        out = E.assemble(topo, model, qpos, qvel, target_pos, kp, kd, qfrc,
                         cfg.self_collision, vf_body, vf_gate_mode(cfg))
        if trace is not None:
            trace.append(out["contact_active"].cpu().numpy())
        if (i == 0 and inverses is None) or i == refresh_at:
            Xpd, Xfd = exact_inverse(out["A_pd"]), exact_inverse(out["A_fd"])
            if precond_bf16:
                Xpd, Xfd = round_bf16(Xpd), round_bf16(Xfd)
        qacc_des = pcg_solve(out["A_pd"], out["pd_rhs"], Xpd, pd_iters,
                             precond_bf16)
        tau = E.pd_torque_from_accel(model, qvel, out["qpos_err"], kp, kd,
                                     qacc_des)
        rhs = out["rhs_base"].clone()
        rhs[:, 6:] += tau
        qacc = pcg_solve(out["A_fd"], rhs, Xfd, fd_iters, precond_bf16)
        qpos, qvel = E.integrate(model, qpos, qvel, qacc)
    return qpos, qvel, (Xpd, Xfd)


def torque_substeps(topo: Topology, cfg, model: Model, qpos, qvel, actions,
                    rfc_rate):
    """One control step under direct joint torques (action_type "torque";
    uhc_tpu/envs/humanoid_im.py:150-152,195-198): τ = clip(ctrl · a_scale ·
    100, ±torque_lim), held over the frame_skip substeps, no PD target;
    RFC as under position control; each substep `engine.substep_torque`,
    one exact solve -> (qpos, qvel)."""
    check_supported(cfg)
    ndof, vf_dim, _ = action_dims(topo, cfg)
    model = model_per_env(model, qpos.shape[0])
    tau = torch.maximum(torch.minimum(actions[:, :ndof] * model.a_scale
                                      * 100.0, model.torque_lim),
                        -model.torque_lim)
    vf_body = explicit_wrench(topo, cfg, model, actions, ndof, vf_dim)
    for _ in range(cfg.frame_skip):
        qfrc = implicit_rfc(cfg, qpos, actions, ndof, rfc_rate)
        qpos, qvel, _ = E.substep_torque(topo, model, qpos, qvel, tau, qfrc,
                                         cfg.self_collision, vf_body,
                                         vf_gate_mode(cfg))
    return qpos, qvel
