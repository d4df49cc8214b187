"""Quaternion / rotation math (PyTorch twin of uhc_tpu.maths.rotations).

The functions the port's paths call. Conventions are
the JAX package's: quaternions are ``(..., 4)`` tensors in wxyz order with
the Hamilton product, joint euler angles are intrinsic Z-Y-X stored as
``[z, y, x]``, and every function broadcasts over leading dimensions.
"""
from __future__ import annotations

import math

import torch

from uhc_tpu_torch.utils.spans import count


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis (broadcasting leading dims)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, wxyz order."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    # a tensor copied from the host: on a card the copy waits for the
    # stream (utils/spans.py counts it)
    count("host_sync")
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """conj(q)/|q|² (equals `quat_conj` for unit quaternions)."""
    n = torch.clamp((q * q).sum(-1, keepdim=True),
                    min=torch.finfo(q.dtype).tiny)
    return quat_conj(q) / n


def _safe_norm(v: torch.Tensor, eps: float) -> torch.Tensor:
    sq = (v * v).sum(-1, keepdim=True)
    safe = sq > eps * eps
    return torch.where(safe, torch.sqrt(torch.where(safe, sq, 1.0)),
                       torch.full_like(sq, eps))


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / _safe_norm(q, eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) @ v for unit q (v + 2(w·u×v + u×(u×v)))."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion, w >= 0: Shepperd's
    four constructions, the one with the largest pivot taken."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    piv = torch.stack([1.0 + tr,
                       1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                       1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                       1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]],
                      dim=-1)
    case = torch.argmax(piv, dim=-1, keepdim=True)
    s = 2.0 * torch.sqrt(torch.clamp(torch.gather(piv, -1, case)[..., 0],
                                     min=1e-12))
    d21, d02, d10 = (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1])
    s01, s02, s12 = (m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1])
    cands = torch.stack([
        torch.stack([s / 4.0, d21 / s, d02 / s, d10 / s], -1),
        torch.stack([d21 / s, s / 4.0, s01 / s, s02 / s], -1),
        torch.stack([d02 / s, s01 / s, s / 4.0, s12 / s], -1),
        torch.stack([d10 / s, s02 / s, s12 / s, s / 4.0], -1)], dim=-2)
    q = torch.gather(cands, -2, case[..., None].expand(
        case.shape[:-1] + (1, 4)))[..., 0, :]
    return quat_normalize(q * torch.where(q[..., 0:1] < 0, -1.0, 1.0))


def quat_from_axis_angle(axis: torch.Tensor,
                         angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3) and angle (...) -> quaternion."""
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_from_rotvec(rv: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Exponential map (axis·angle -> quaternion), small-angle safe."""
    sq = (rv * rv).sum(-1, keepdim=True)
    safe = sq > eps * eps
    angle = torch.where(safe, torch.sqrt(torch.where(safe, sq, 1.0)), 0.0)
    half = 0.5 * angle
    k = torch.where(safe, torch.sin(half) / torch.where(safe, angle, 1.0),
                    0.5 - sq / 48.0)
    return torch.cat([torch.cos(half), rv * k], dim=-1)


def quat_to_rotvec(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Log map with |rv| <= π (sign-fixed so w >= 0)."""
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    vn = _safe_norm(q[..., 1:4], 1e-12)
    angle = 2.0 * torch.atan2(vn, q[..., 0:1])
    k = torch.where(vn < eps, 2.0 / torch.clamp(q[..., 0:1], min=eps),
                    angle / torch.clamp(vn, min=eps))
    return q[..., 1:4] * k


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor,
                   dt) -> torch.Tensor:
    """q ⊗ exp(ω_local·dt), renormalized (MuJoCo free-joint semantics)."""
    return quat_normalize(quat_mul(q, quat_from_rotvec(omega_local * dt)))


def quat_from_euler_zyx(e: torch.Tensor) -> torch.Tensor:
    """Euler [z, y, x] (intrinsic ZYX) -> quaternion."""
    hz, hy, hx = e[..., 0] * 0.5, e[..., 1] * 0.5, e[..., 2] * 0.5
    cz, sz = torch.cos(hz), torch.sin(hz)
    cy, sy = torch.cos(hy), torch.sin(hy)
    cx, sx = torch.cos(hx), torch.sin(hx)
    return torch.stack([
        cz * cy * cx + sz * sy * sx,
        cz * cy * sx - sz * sy * cx,
        cz * sy * cx + sz * cy * sx,
        sz * cy * cx - cz * sy * sx,
    ], dim=-1)


def euler_zyx_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ez = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    ey = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    ex = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    return torch.stack([ez, ey, ex], dim=-1)


def heading_quat(q: torch.Tensor) -> torch.Tensor:
    """Zero the x/y imaginary parts and renormalize."""
    count("host_sync")
    return quat_normalize(q * q.new_tensor([1.0, 0.0, 0.0, 1.0]))


def heading_angle(q: torch.Tensor) -> torch.Tensor:
    """2·atan2(z, w) of the sign-fixed heading quaternion, in [0, 2π)."""
    w = q[..., 0]
    z = q[..., 3]
    w = w * torch.where(z < 0, -1.0, 1.0)
    z = torch.abs(z)
    safe = (w * w + z * z) > 1e-16
    return 2.0 * torch.atan2(torch.where(safe, z, 0.0),
                             torch.where(safe, w, 1.0))


def heading_angle_new(q: torch.Tensor) -> torch.Tensor:
    """Yaw via atan2, in (-π, π] (the obs v5 / v6 heading)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def heading_quat_new(q: torch.Tensor) -> torch.Tensor:
    """The rotation about +z by `heading_angle_new`."""
    half = 0.5 * heading_angle_new(q)
    zeros = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], -1)


def de_heading(q: torch.Tensor) -> torch.Tensor:
    return quat_mul(quat_inv(heading_quat(q)), q)


def de_heading_new(q: torch.Tensor) -> torch.Tensor:
    return quat_mul(quat_inv(heading_quat_new(q)), q)


def wrap_to_pi(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (-π, π] (round half to even, as jnp.round)."""
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def transform_vec(v: torch.Tensor, q: torch.Tensor,
                  trans: str = "root") -> torch.Tensor:
    """Express world vector v in the frame of q ("root"), its heading
    ("heading") or its atan2 heading ("heading_new")."""
    if trans == "root":
        fq = q
    elif trans == "heading":
        fq = heading_quat(q)
    elif trans == "heading_new":
        fq = heading_quat_new(q)
    else:
        raise ValueError(f"unknown trans {trans!r}")
    return quat_rotate_inv(fq, v)


def multi_quat_diff(nq1: torch.Tensor, nq0: torch.Tensor) -> torch.Tensor:
    s = nq1.shape
    q1 = nq1.reshape(s[:-1] + (-1, 4))
    q0 = nq0.reshape(s[:-1] + (-1, 4))
    return quat_mul(q1, quat_inv(q0)).reshape(s)


def multi_quat_norm(nq: torch.Tensor) -> torch.Tensor:
    s = nq.shape
    w = nq.reshape(s[:-1] + (-1, 4))[..., 0]
    return torch.arccos(torch.clamp(w, -1.0, 1.0))


def multi_quat_norm_v2(nq: torch.Tensor) -> torch.Tensor:
    """Distance from the identity per joint, ‖(|w| - 1, x, y, z)‖, over a
    flat (..., 4J) layout."""
    s = nq.shape
    q = nq.reshape(s[:-1] + (-1, 4))
    d = torch.cat([q[..., 0:1].abs() - 1.0, q[..., 1:]], dim=-1)
    return torch.linalg.vector_norm(d, dim=-1)


def angvel_fd(prev_q: torch.Tensor, cur_q: torch.Tensor, dt) -> torch.Tensor:
    """rotvec(q_cur ⊗ q_prev⁻¹)/dt over a flat (..., 4J) layout."""
    s = cur_q.shape
    dq = quat_mul(cur_q.reshape(s[:-1] + (-1, 4)),
                  quat_inv(prev_q.reshape(s[:-1] + (-1, 4))))
    return (quat_to_rotvec(dq) / dt).reshape(s[:-1] + (-1,))


def qvel_fd(cur_qpos: torch.Tensor, next_qpos: torch.Tensor,
            dt) -> torch.Tensor:
    """Finite-difference generalized velocity between two qpos frames."""
    v = (next_qpos[..., :3] - cur_qpos[..., :3]) / dt
    dq = quat_mul(next_qpos[..., 3:7], quat_inv(cur_qpos[..., 3:7]))
    rv = quat_to_rotvec(dq) / dt
    rv = transform_vec(rv, cur_qpos[..., 3:7], "root")
    diff = wrap_to_pi(next_qpos[..., 7:] - cur_qpos[..., 7:])
    return torch.cat([v, rv, diff / dt], dim=-1)


def qvel_fd_ball(cur_qpos: torch.Tensor, next_qpos: torch.Tensor,
                 dt) -> torch.Tensor:
    """Finite-difference generalized velocity of ball-joint qpos (root as
    `qvel_fd`; each joint's child-local angular velocity
    rotvec(q_cur⁻¹ ⊗ q_next)/dt, the coordinates `quat_integrate`
    advances)."""
    v = (next_qpos[..., :3] - cur_qpos[..., :3]) / dt
    dq = quat_mul(next_qpos[..., 3:7], quat_inv(cur_qpos[..., 3:7]))
    rv = transform_vec(quat_to_rotvec(dq) / dt, cur_qpos[..., 3:7], "root")
    s = cur_qpos.shape
    jc = cur_qpos[..., 7:].reshape(s[:-1] + (-1, 4))
    jn = next_qpos[..., 7:].reshape(s[:-1] + (-1, 4))
    w = quat_to_rotvec(quat_mul(quat_inv(jc), jn)) / dt
    return torch.cat([v, rv, w.reshape(s[:-1] + (-1,))], dim=-1)
