"""Rigid-body engine for reduced-coordinate humanoids (PyTorch twin of
uhc_tpu.physics.engine), batched over a leading env axis.

Every function takes state of shape (B, ...) and a `Model` of tensors
that is either shared (unbatched leaves) or per env (leaves with a leading
(B,) dim, from `env_models` over a model library): each function reads
the model through `model_per_env`, which expands shared leaves to per-env
views without a copy, so one code path serves both. The design is the
JAX package's: dense body Jacobians make
the mass matrix, bias force and contact projections plain batched matrix
products; contacts are penalty springs with velocity-implicit damping.
All contractions run in float32 (TF32 is off, see the package docstring).

Per substep (450 Hz): FK -> velocities -> Jacobians -> M and bias force ->
ground contact, self-collision, joint-limit and scene-object terms ->
the two SPD systems of stable PD and forward dynamics (`assemble`) ->
semi-implicit integration (`substep`, the exact chain).

Joints are three z-y-x hinges (`joint_kind="euler"`) or one quaternion
each (`"ball"`, the reference's robot.ball family): a ball joint's dofs
are the child body's local angular velocity, its motion subspace the
child's world-frame axes; it has no range limits, integrates its
quaternion like the root's and is driven by direct torques
(`substep_torque`, no stable-PD system).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from uhc_tpu_torch.maths import (cross, quat_integrate, quat_mul,
                                 quat_normalize, quat_rotate, quat_to_mat)
from uhc_tpu_torch.physics.model import Model, Topology, model_per_env


@functools.lru_cache(maxsize=None)
def _tables(topo: Topology, device_str: str):
    dev = torch.device(device_str)
    levels = [(torch.as_tensor(i, device=dev), torch.as_tensor(p, device=dev))
              for i, p in topo.levels()]
    return {
        "levels": levels,
        "parents": torch.as_tensor(np.asarray(topo.parents[1:], np.int64),
                                   device=dev),
        "dof_body": torch.as_tensor(topo.dof_body(), device=dev),
        "mask": torch.as_tensor(topo.ancestor_mask(), device=dev),
    }


def tables(topo: Topology, device) -> dict:
    return _tables(topo, str(torch.device(device)))


# ---------------------------------------------------------------------------
# Kinematics
# ---------------------------------------------------------------------------


def fk(topo: Topology, model: Model, qpos: torch.Tensor) -> dict:
    """Forward kinematics, level-vectorized over the tree.

    Returns xpos (B,nb,3), xquat (B,nb,4), xipos (B,nb,3) and the per-dof
    world axes / anchors (B,nv,3)."""
    if topo.joint_kind not in ("euler", "ball"):
        raise ValueError(f"unknown joint kind {topo.joint_kind!r}")
    ball = topo.joint_kind == "ball"
    tb = tables(topo, qpos.device)
    B, nb = qpos.shape[0], topo.nbody
    model = model_per_env(model, B)
    root_q = quat_normalize(qpos[:, 3:7])
    if ball:
        q_local = quat_normalize(qpos[:, 7:].reshape(B, nb - 1, 4))
    else:
        e = qpos[:, 7:].reshape(B, nb - 1, 3) * 0.5
        cz, sz = torch.cos(e[..., 0]), torch.sin(e[..., 0])
        cy, sy = torch.cos(e[..., 1]), torch.sin(e[..., 1])
        cx, sx = torch.cos(e[..., 2]), torch.sin(e[..., 2])
        zero = torch.zeros_like(cz)
        q_z = torch.stack([cz, zero, zero, sz], -1)
        q_y = torch.stack([cy, zero, sy, zero], -1)
        q_x = torch.stack([cx, sx, zero, zero], -1)
        q_zy = quat_mul(q_z, q_y)
        q_local = quat_mul(q_zy, q_x)

    xpos = qpos.new_zeros((B, nb, 3))
    xquat = qpos.new_zeros((B, nb, 4))
    xpos[:, 0] = qpos[:, 0:3]
    xquat[:, 0] = root_q
    for idx, par in tb["levels"]:
        qp = xquat[:, par]
        xpos[:, idx] = xpos[:, par] + quat_rotate(qp,
                                                  model.body_pos[:, idx])
        xquat[:, idx] = quat_mul(qp, q_local[:, idx - 1])

    xipos = xpos + quat_rotate(xquat, model.body_ipos)

    eye = torch.eye(3, dtype=qpos.dtype, device=qpos.device)
    if ball:
        # the child body's world-frame x, y, z columns
        jq = xquat[:, 1:]
        joint_axes = torch.stack([quat_rotate(jq, eye[k]) for k in range(3)],
                                 2).reshape(B, -1, 3)
    else:
        qp_all = xquat[:, tb["parents"]]
        a_z = quat_rotate(qp_all, eye[2])
        a_y = quat_rotate(quat_mul(qp_all, q_z), eye[1])
        a_x = quat_rotate(quat_mul(qp_all, q_zy), eye[0])
        joint_axes = torch.stack([a_z, a_y, a_x], 2).reshape(B, -1, 3)
    R0 = quat_to_mat(root_q)
    axes = torch.cat([eye.expand(B, 3, 3), R0.transpose(1, 2), joint_axes], 1)
    anchors = xpos[:, tb["dof_body"]]
    return dict(xpos=xpos, xquat=xquat, xipos=xipos, axes=axes,
                anchors=anchors)


def velocities(topo: Topology, kin: dict, qvel: torch.Tensor) -> dict:
    """Body angular/linear velocities and bias (q̈=0) accelerations."""
    tb = tables(topo, qvel.device)
    B, nb = qvel.shape[0], topo.nbody
    xpos, xipos, axes = kin["xpos"], kin["xipos"], kin["axes"]
    jaxes = axes[:, 6:].reshape(B, nb - 1, 3, 3)
    jdq = qvel[:, 6:].reshape(B, nb - 1, 3)
    ball = topo.joint_kind == "ball"
    if ball:
        # each joint's world angular velocity Σ_k a_k ω_k
        jw = torch.einsum("bjkc,bjk->bjc", jaxes, jdq)

    omega = qvel.new_zeros((B, nb, 3))
    v = qvel.new_zeros((B, nb, 3))
    alpha = qvel.new_zeros((B, nb, 3))
    a = qvel.new_zeros((B, nb, 3))
    omega[:, 0] = (axes[:, 3] * qvel[:, 3:4] + axes[:, 4] * qvel[:, 4:5]
                   + axes[:, 5] * qvel[:, 5:6])
    v[:, 0] = qvel[:, 0:3]
    for idx, par in tb["levels"]:
        w0 = omega[:, par]
        if ball:
            # the subspace turns with the child: its rate is ω_parent × S q̇
            wj = jw[:, idx - 1]
            wi = w0 + wj
            al = alpha[:, par] + cross(w0, wj)
        else:
            az, ay, ax = (jaxes[:, idx - 1, 0], jaxes[:, idx - 1, 1],
                          jaxes[:, idx - 1, 2])
            dz = jdq[:, idx - 1, 0:1]
            dy = jdq[:, idx - 1, 1:2]
            dx = jdq[:, idx - 1, 2:3]
            w1 = w0 + az * dz
            w2 = w1 + ay * dy
            wi = w2 + ax * dx
            al = (alpha[:, par] + cross(w0, az) * dz + cross(w1, ay) * dy
                  + cross(w2, ax) * dx)
        d = xpos[:, idx] - xpos[:, par]
        vi = v[:, par] + cross(w0, d)
        ai = a[:, par] + cross(alpha[:, par], d) + cross(w0, cross(w0, d))
        omega[:, idx] = wi
        alpha[:, idx] = al
        v[:, idx] = vi
        a[:, idx] = ai
    r = xipos - xpos
    acom = a + cross(alpha, r) + cross(omega, cross(omega, r))
    return dict(omega=omega, vel=v, alpha_bias=alpha, a_bias=a,
                acom_bias=acom)


# ---------------------------------------------------------------------------
# Dynamics quantities
# ---------------------------------------------------------------------------


def jacobians(topo: Topology, kin: dict):
    """Dense COM Jacobians Jlin, Jang of shape (B, nb, 3, nv)."""
    mask = tables(topo, kin["axes"].device)["mask"].to(kin["axes"].dtype)
    axes, anchors, xipos = kin["axes"], kin["anchors"], kin["xipos"]
    nv = axes.shape[1]
    is_lin = torch.zeros(nv, dtype=axes.dtype, device=axes.device)
    is_lin[0:3] = 1.0
    r = xipos[:, :, None, :] - anchors[:, None, :, :]          # (B,nb,nv,3)
    rc = cross(axes[:, None, :, :], r)                          # a_j × r
    lin = is_lin[:, None]
    Jlin = mask[None, :, :, None] * (lin * axes[:, None] + (1.0 - lin) * rc)
    Jang = (mask * (1.0 - is_lin))[None, :, :, None] * axes[:, None]
    return Jlin.transpose(2, 3), Jang.transpose(2, 3)


def world_inertia_factors(model: Model, xquat: torch.Tensor):
    """Principal world rotation R·R_iquat (B,nb,3,3) and √diag inertia
    (B,nb,3)."""
    model = model_per_env(model, xquat.shape[0])
    Rtot = quat_to_mat(quat_mul(xquat, model.body_iquat))
    return Rtot, torch.sqrt(model.body_inertia)


def mass_matrix(model: Model, Jlin, Jang, Rtot, sqI) -> torch.Tensor:
    """M = GᵀG + diag(armature), G = [√m·Jlin ; √I·Rᵀ·Jang] per body."""
    B, nb, _, nv = Jlin.shape
    model = model_per_env(model, B)
    Glin = torch.sqrt(model.body_mass)[:, :, None, None] * Jlin
    Gang = sqI[:, :, :, None] * torch.matmul(Rtot.transpose(-1, -2), Jang)
    G = torch.cat([Glin, Gang], 2).reshape(B, nb * 6, nv)
    return (torch.matmul(G.transpose(1, 2), G)
            + torch.diag_embed(model.armature))


def bias_force(model: Model, vel: dict, Jlin, Jang, Rtot) -> torch.Tensor:
    """qfrc_bias (Coriolis + centrifugal + gravity): M q̈ + C = qfrc."""
    model = model_per_env(model, Rtot.shape[0])
    Iw = torch.matmul(Rtot * model.body_inertia[:, :, None, :],
                      Rtot.transpose(-1, -2))
    f = model.body_mass[:, :, None] * (vel["acom_bias"]
                                       - model.gravity[:, None])
    w = vel["omega"]
    t = (torch.matmul(Iw, vel["alpha_bias"][..., None])[..., 0]
         + cross(w, torch.matmul(Iw, w[..., None])[..., 0]))
    return project(Jlin, Jang, f, t)


def project(Jlin, Jang, F, T) -> torch.Tensor:
    """Σ_b Jlin_bᵀ F_b + Jang_bᵀ T_b: per-body world wrenches (B,nb,3) ->
    generalized forces (B,nv)."""
    return (torch.einsum("bnaj,bna->bj", Jlin, F)
            + torch.einsum("bnaj,bna->bj", Jang, T))


# ---------------------------------------------------------------------------
# Contacts (ground plane z=0), self-collision, joint limits
# ---------------------------------------------------------------------------


def contact_terms(topo: Topology, model: Model, kin: dict, vel: dict):
    """Ground contacts at the hull points: explicit depth-capped normal
    springs and implicit damping/friction.

    Returns F (B,nb,3) spring forces, T (B,nb,3) spring torques about body
    COMs, W (B,nb,6,6) implicit damping wrenches, all in the world frame."""
    xpos, xquat, xipos = kin["xpos"], kin["xquat"], kin["xipos"]
    model = model_per_env(model, xpos.shape[0])
    cp, cmask = model.contact_point, model.contact_mask
    cpx, cpy, cpz = cp[..., 0], cp[..., 1], cp[..., 2]
    qw, qx = xquat[..., 0:1], xquat[..., 1:2]
    qy, qz = xquat[..., 2:3], xquat[..., 3:4]
    tx = 2.0 * (qy * cpz - qz * cpy)
    ty = 2.0 * (qz * cpx - qx * cpz)
    tz = 2.0 * (qx * cpy - qy * cpx)
    dx = cpx + qw * tx + (qy * tz - qz * ty)
    dy = cpy + qw * ty + (qz * tx - qx * tz)
    dz = cpz + qw * tz + (qx * ty - qy * tx)
    wpz = xpos[..., 2:3] + dz
    om, vv = vel["omega"], vel["vel"]
    ox, oy, oz = om[..., 0:1], om[..., 1:2], om[..., 2:3]
    vpx = vv[..., 0:1] + (oy * dz - oz * dy)
    vpy = vv[..., 1:2] + (oz * dx - ox * dz)

    active = (wpz < 0.0).to(wpz.dtype) * cmask
    pen = torch.clamp(-wpz, min=0.0)
    def per_env(x):        # (B,) scalar leaf -> (B, 1, 1)
        return x[:, None, None]

    pen = torch.minimum(pen, per_env(model.contact_depth_cap))
    fn = per_env(model.contact_stiffness) * pen * active
    vt_norm = torch.sqrt(vpx ** 2 + vpy ** 2 + 1e-12)
    b = per_env(model.contact_damping) * active
    a = active * torch.clamp(
        per_env(model.friction) * fn / torch.maximum(
            vt_norm, per_env(model.contact_vreg)), max=2000.0)

    rx = xpos[..., 0:1] + dx - xipos[..., 0:1]
    ry = xpos[..., 1:2] + dy - xipos[..., 1:2]
    rz = wpz - xipos[..., 2:3]
    zs = torch.zeros_like(fn[..., 0])
    F = torch.stack([zs, zs, fn.sum(-1)], -1)
    T = torch.stack([(fn * ry).sum(-1), -(fn * rx).sum(-1), zs], -1)

    sa, sb = a.sum(-1), b.sum(-1)
    sarx, sary, sarz = (a * rx).sum(-1), (a * ry).sum(-1), (a * rz).sum(-1)
    sbrx, sbry = (b * rx).sum(-1), (b * ry).sum(-1)
    z = torch.zeros_like(sa)
    Wll = torch.stack([torch.stack([sa, z, z], -1),
                       torch.stack([z, sa, z], -1),
                       torch.stack([z, z, sb], -1)], -2)
    Wla = torch.stack([torch.stack([z, sarz, -sary], -1),
                       torch.stack([-sarz, z, sarx], -1),
                       torch.stack([sbry, -sbrx, z], -1)], -2)
    arz2, arx2, ary2 = ((a * rz * rz).sum(-1), (a * rx * rx).sum(-1),
                        (a * ry * ry).sum(-1))
    arxz, aryz = (a * rx * rz).sum(-1), (a * ry * rz).sum(-1)
    brx2, bry2, brxy = ((b * rx * rx).sum(-1), (b * ry * ry).sum(-1),
                        (b * rx * ry).sum(-1))
    Waa = torch.stack([
        torch.stack([arz2 + bry2, -brxy, -arxz], -1),
        torch.stack([-brxy, arz2 + brx2, -aryz], -1),
        torch.stack([-arxz, -aryz, arx2 + ary2], -1)], -2)
    top = torch.cat([Wll, Wla], -1)
    bot = torch.cat([Wla.transpose(-1, -2), Waa], -1)
    return F, T, torch.cat([top, bot], -2)


def self_collision_terms(topo: Topology, model: Model, kin: dict, vel: dict,
                         k: float = 3000.0, d: float = 50.0):
    """Body-body penalty contacts over the curated pair set: each body is a
    chain of SC spheres; returns world force/torque-about-COM sums
    (B,nb,3) each."""
    from uhc_tpu_torch.smpl.constants import self_collision_pairs

    pairs = self_collision_pairs(topo)
    xpos, xquat, xipos = kin["xpos"], kin["xquat"], kin["xipos"]
    B, nb = xpos.shape[0], topo.nbody
    model = model_per_env(model, B)
    if len(pairs) == 0:
        z = xpos.new_zeros((B, nb, 3))
        return z, z
    dev = xpos.device
    pi = torch.as_tensor(pairs[:, 0].astype(np.int64), device=dev)
    pj = torch.as_tensor(pairs[:, 1].astype(np.int64), device=dev)

    def world_spheres(idx):
        return xpos[:, idx, None] + quat_rotate(xquat[:, idx, None],
                                                model.sc_point[:, idx])

    wi, wj = world_spheres(pi), world_spheres(pj)          # (B,P,SC,3)
    ri = model.sc_radius[:, pi][:, :, None, None]
    rj = model.sc_radius[:, pj][:, :, None, None]
    diff = wi[:, :, :, None] - wj[:, :, None]              # (B,P,SC,SC,3)
    dist = torch.sqrt((diff ** 2).sum(-1) + 1e-12)
    depth = (ri + rj) - dist
    act = (depth > 0.0).to(dist.dtype)
    n = diff / dist[..., None]
    vel_i = vel["vel"][:, pi, None] + cross(vel["omega"][:, pi, None],
                                            wi - xpos[:, pi, None])
    vel_j = vel["vel"][:, pj, None] + cross(vel["omega"][:, pj, None],
                                            wj - xpos[:, pj, None])
    vrel = vel_i[:, :, :, None] - vel_j[:, :, None]
    vn = (vrel * n).sum(-1)
    fn = torch.clamp(k * depth - d * vn, min=0.0) * act
    Fp = fn[..., None] * n
    pt = 0.5 * (wi[:, :, :, None] + wj[:, :, None])
    Fi = Fp.sum((2, 3))
    Ti = cross(pt - xipos[:, pi, None, None], Fp).sum((2, 3))
    Tj = cross(pt - xipos[:, pj, None, None], -Fp).sum((2, 3))
    # per-pair wrenches to bodies with one-hot products, as the JAX engine
    eye = torch.eye(nb, dtype=xpos.dtype, device=dev)
    Oi, Oj = eye[pi].T, eye[pj].T                          # (nb, P)
    return (torch.matmul(Oi, Fi) - torch.matmul(Oj, Fi),
            torch.matmul(Oi, Ti) + torch.matmul(Oj, Tj))


def limit_qfrc(model: Model, qpos, qvel, k: float = 500.0, d: float = 20.0):
    """Joint-range penalty: spring force (B,nv), implicit damping (B,nv);
    zero for ball joints (qpos wider than nv + 1), which have no ranges."""
    if qpos.shape[1] != qvel.shape[1] + 1:
        z = qvel.new_zeros(qvel.shape)
        return z, z
    q = qpos[:, 7:]
    model = model_per_env(model, qpos.shape[0])
    lo, hi = model.jnt_range[..., 0], model.jnt_range[..., 1]
    below = torch.clamp(lo - q, min=0.0)
    above = torch.clamp(q - hi, min=0.0)
    out = ((below > 0) | (above > 0)).to(qpos.dtype)
    zeros6 = qpos.new_zeros((qpos.shape[0], 6))
    return (torch.cat([zeros6, k * (below - above)], 1),
            torch.cat([zeros6, out * d], 1))


def stable_pd_errors(model: Model, qpos, qvel, target_pos, kp, kd, C):
    """(rhs of the q̈_des system, qpos_err, kd_full); kp/kd are (B, ndof)."""
    z6 = qpos.new_zeros((qpos.shape[0], 6))
    model = model_per_env(model, qpos.shape[0])
    kp_full = torch.cat([z6, kp.expand(qpos.shape[0], -1)], 1)
    kd_full = torch.cat([z6, kd.expand(qpos.shape[0], -1)], 1)
    qpos_err = torch.cat([z6, qpos[:, 7:] + qvel[:, 6:] * model.dt[:, None]
                          - target_pos], 1)
    rhs = -C - kp_full * qpos_err - kd_full * qvel
    return rhs, qpos_err, kd_full


def integrate(model: Model, qpos, qvel, qacc):
    """Semi-implicit Euler; the root quaternion integrates its local
    angular velocity, and so does each joint quaternion of a ball-joint
    qpos (7 + 4·nj wide)."""
    B = qpos.shape[0]
    dt = model_per_env(model, B).dt[:, None]
    qvel_new = qvel + dt * qacc
    root_pos = qpos[:, 0:3] + dt * qvel_new[:, 0:3]
    root_quat = quat_integrate(qpos[:, 3:7], qvel_new[:, 3:6], dt)
    nj = (qvel.shape[1] - 6) // 3
    if nj > 0 and qpos.shape[1] == 7 + 4 * nj:
        joints = quat_integrate(qpos[:, 7:].reshape(B, nj, 4),
                                qvel_new[:, 6:].reshape(B, nj, 3),
                                dt[:, :, None]).reshape(B, -1)
    else:
        joints = qpos[:, 7:] + dt * qvel_new[:, 6:]
    return torch.cat([root_pos, root_quat, joints], 1), qvel_new


def pd_torque_from_accel(model: Model, qvel, qpos_err, kp, kd, qacc_des):
    """τ = -Kp e - Kd(ė + q̈_des·dt), clipped to the torque limits."""
    model = model_per_env(model, qvel.shape[0])
    tau = -kp * qpos_err[:, 6:] - kd * (qvel[:, 6:] + qacc_des[:, 6:]
                                        * model.dt[:, None])
    return torch.maximum(torch.minimum(tau, model.torque_lim),
                         -model.torque_lim)


def project_vf_cp(model: Model, cp):
    """Clamp explicit-RFC contact points (B, nb, num_each, 3), body frame,
    into each body's hull AABB (uhc_tpu/physics/engine.py:503
    project_vf_cp): interior points pass through, outside points snap to
    the box, so the lever arm stays within the body's extent."""
    model = model_per_env(model, cp.shape[0])
    pts, m = model.contact_point, model.contact_mask[..., None] > 0
    lo = torch.where(m, pts, 1e9).amin(-2, keepdim=True)
    hi = torch.where(m, pts, -1e9).amax(-2, keepdim=True)
    return torch.minimum(torch.maximum(cp, lo), hi)


def prep_explicit_vf(model: Model, cfg, vf, nbody: int):
    """The explicit-RFC action segment (B, nbody · num_each · bvd) -> one
    (B, nbody, 9) body-frame [cp|f|τ] wrench per body
    (uhc_tpu/physics/engine.py:517 prep_explicit_vf): each slot's contact
    point hull-projected when residual_contact_projection is set, force
    and torque scaled by residual_force_scale alone (rfc_rate scales only
    implicit RFC). With num_each > 1 the slots fold into one wrench at
    cp = 0: τ = Σ (τ_i + cp_i × f_i), exact since rotation preserves
    cross products."""
    B = vf.shape[0]
    bvd = vf.shape[1] // (nbody * cfg.residual_force_bodies_num)
    v = vf.reshape(B, nbody, -1, bvd)
    scale = cfg.residual_force_scale
    cp = v[..., 0:3]
    if cfg.residual_contact_projection:
        cp = project_vf_cp(model, cp)
    f = v[..., 3:6] * scale
    t = (v[..., 6:9] * scale if cfg.residual_force_torque
         else torch.zeros_like(f))
    if v.shape[2] > 1:
        f_sum = f.sum(2)
        return torch.cat([torch.zeros_like(f_sum), f_sum,
                          (t + cross(cp, f)).sum(2)], -1)
    return torch.cat([cp[:, :, 0], f[:, :, 0], t[:, :, 0]], -1)


def vf_contact_gate(model: Model, kin: dict, mode: str):
    """(B, nb) 0/1 gate of explicit RFC (uhc_tpu/physics/engine.py:563
    vf_contact_gate): "height" = body origin z <= 0.12, "ground" = some
    active hull point of the body lies below the ground plane."""
    xpos = kin["xpos"]
    if mode == "height":
        return (xpos[..., 2] <= 0.12).to(xpos.dtype)
    model = model_per_env(model, xpos.shape[0])
    wp = xpos[:, :, None] + quat_rotate(kin["xquat"][:, :, None],
                                        model.contact_point)
    touch = (wp[..., 2] < 0.0).to(xpos.dtype) * model.contact_mask
    return touch.amax(-1)


def assemble(topo: Topology, model: Model, qpos, qvel, target_pos, kp, kd,
             qfrc_applied, self_collision: bool = False, vf_body=None,
             vf_gate=None, obj=None) -> dict:
    """Everything of a substep except the linear solves: the stable-PD
    system A_pd = M + dt·Kd, the forward-dynamics system
    A_fd = M + dt·(CD + limit damping), the PD right-hand side and the
    force terms of the forward-dynamics right-hand side. A ball-joint
    tree has no stable-PD system (its joints take direct torques): A_pd is
    M and the PD terms are zero. `vf_body` is the
    (B, nb, 9) body-frame wrench of explicit RFC (`prep_explicit_vf`):
    rotated into the world by each body's current orientation, gated by
    `vf_gate` (None, "height" or "ground"), and applied at the body
    origin + cp (uhc_tpu/physics/engine.py:635-647). `obj` = (ObjModel,
    obj_qpos (B, NO, 7), obj_qvel (B, NO, 6)) adds the dynamic scene
    objects' contacts (`physics.objects`): the humanoid's side joins the
    contact forces before the projection, the objects' side is returned
    as "obj_wrench" for `objects.obj_substep`."""
    model = model_per_env(model, qpos.shape[0])
    kin = fk(topo, model, qpos)
    vel = velocities(topo, kin, qvel)
    Jlin, Jang = jacobians(topo, kin)
    Rtot, sqI = world_inertia_factors(model, kin["xquat"])
    M = mass_matrix(model, Jlin, Jang, Rtot, sqI)
    C = bias_force(model, vel, Jlin, Jang, Rtot)

    F, T, W = contact_terms(topo, model, kin, vel)
    qfrc_con = project(Jlin, Jang, F, T)
    if self_collision:
        Fsc, Tsc = self_collision_terms(topo, model, kin, vel)
        qfrc_con = qfrc_con + project(Jlin, Jang, Fsc, Tsc)
    obj_wrench = None
    if obj is not None:
        from uhc_tpu_torch.physics import objects as OBJ

        om, obj_qpos, obj_qvel = obj
        Fob, Tob, F_obj, T_obj = OBJ.humanoid_obj_contacts(
            topo, model, kin, vel, om, obj_qpos[..., :3],
            obj_qpos[..., 3:7], obj_qvel[..., :3], obj_qvel[..., 3:6])
        qfrc_con = qfrc_con + project(Jlin, Jang, Fob, Tob)
        obj_wrench = (F_obj, T_obj)
    qfrc_lim, lim_damp = limit_qfrc(model, qpos, qvel)

    B, nb, _, nv = Jlin.shape
    J6 = torch.cat([Jlin, Jang], 2)                          # (B,nb,6,nv)
    K = torch.matmul(W, J6)
    CD = torch.matmul(J6.reshape(B, -1, nv).transpose(1, 2),
                      K.reshape(B, -1, nv))
    v6 = torch.cat([vel["vel"] + cross(vel["omega"],
                                       kin["xipos"] - kin["xpos"]),
                    vel["omega"]], 2)
    qfrc_damp = (-torch.matmul(K.reshape(B, -1, nv).transpose(1, 2),
                               v6.reshape(B, -1, 1))[..., 0]
                 - lim_damp * qvel)

    dt = model.dt[:, None, None]
    if topo.joint_kind == "ball":
        pd_rhs = qpos_err = torch.zeros_like(qvel)
        A_pd = M
    else:
        pd_rhs, qpos_err, kd_full = stable_pd_errors(model, qpos, qvel,
                                                     target_pos, kp, kd, C)
        A_pd = M + torch.diag_embed(kd_full) * dt
    A_fd = M + dt * (CD + torch.diag_embed(lim_damp))
    rhs_base = qfrc_applied + qfrc_con + qfrc_lim + qfrc_damp - C
    if vf_body is not None:
        q = kin["xquat"]
        cp_w, f_w, t_w = (quat_rotate(q, vf_body[..., k:k + 3])
                          for k in (0, 3, 6))
        if vf_gate is not None:
            g = vf_contact_gate(model, kin, vf_gate)[..., None]
            f_w, t_w = f_w * g, t_w * g
        T = cross(kin["xpos"] + cp_w - kin["xipos"], f_w) + t_w
        rhs_base = rhs_base + project(Jlin, Jang, f_w, T)
    return dict(A_pd=A_pd, A_fd=A_fd, pd_rhs=pd_rhs, qpos_err=qpos_err,
                rhs_base=rhs_base,
                contact_active=W.abs().sum((-1, -2)) > 0,
                obj_wrench=obj_wrench)


def substep(topo: Topology, model: Model, qpos, qvel, target_pos, kp, kd,
            qfrc_applied, self_collision: bool = False, vf_body=None,
            vf_gate=None, obj=None):
    """One 450 Hz stable-PD substep of the exact chain
    (uhc_tpu/physics/engine.py:677 substep): `assemble`, the q̈_des system
    and the forward-dynamics system each factored exactly (blocked
    Cholesky), the PD torque between them, semi-implicit integration ->
    (qpos', qvel', tau), and with `obj` the objects' step
    (obj_qpos', obj_qvel') as a fourth item."""
    from uhc_tpu_torch.physics import linalg as LA

    model = model_per_env(model, qpos.shape[0])
    out = assemble(topo, model, qpos, qvel, target_pos, kp, kd, qfrc_applied,
                   self_collision, vf_body, vf_gate, obj)
    qacc_des = LA.blocked_cho_solve(LA.blocked_cholesky(out["A_pd"]),
                                    out["pd_rhs"])
    tau = pd_torque_from_accel(model, qvel, out["qpos_err"], kp, kd, qacc_des)
    rhs = out["rhs_base"].clone()
    rhs[:, 6:] += tau
    qacc = LA.blocked_cho_solve(LA.blocked_cholesky(out["A_fd"]), rhs)
    qpos_n, qvel_n = integrate(model, qpos, qvel, qacc)
    if obj is None:
        return qpos_n, qvel_n, tau
    from uhc_tpu_torch.physics import objects as OBJ

    om, obj_qpos, obj_qvel = obj
    return qpos_n, qvel_n, tau, OBJ.obj_substep(
        model, om, obj_qpos, obj_qvel, *out["obj_wrench"])


def substep_torque(topo: Topology, model: Model, qpos, qvel, tau,
                   qfrc_applied, self_collision: bool = False, vf_body=None,
                   vf_gate=None):
    """One substep under direct joint torques `tau` (B, ndof) (action_type
    "torque", the ball family's control; uhc_tpu/physics/engine.py:651
    substep_torque): the forward-dynamics system alone, factored exactly
    -> (qpos', qvel', tau). No kernel takes this route (nor a Pallas one
    in the JAX package), so the factorization is torch's batched Cholesky
    (one call, no host sync; the JAX package's blocked one rounds
    otherwise); a system that is not positive definite gives a non-finite
    state, which the env fails as blown up."""
    model = model_per_env(model, qpos.shape[0])
    out = assemble(topo, model, qpos, qvel, torch.zeros_like(tau),
                   model.jkp, model.jkd, qfrc_applied, self_collision,
                   vf_body, vf_gate)
    rhs = out["rhs_base"].clone()
    rhs[:, 6:] += tau
    L, _ = torch.linalg.cholesky_ex(out["A_fd"])
    qacc = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    qpos, qvel = integrate(model, qpos, qvel, qacc)
    return qpos, qvel, tau
