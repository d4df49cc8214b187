"""Dynamic scene objects: free rigid bodies coupled to the humanoid
(PyTorch twin of uhc_tpu.physics.objects), batched over envs.

The reference gives each scene object a free joint in the MuJoCo sim
(uhc/envs/humanoid_im.py:159-175, :1284-1287). Here, as in the JAX package,
an object does not join the humanoid's tree: each is a 6-dof box or sphere
with its own closed-form free-body step, coupled to the humanoid through
penalty contacts:

* humanoid side: the self-collision sphere chains (model.sc_point /
  sc_radius) against each object's primitive; the world wrenches join the
  ground-contact wrench before the Jacobian projection in
  `engine.assemble`;
* object side: the equal and opposite wrench plus its own ground contact
  (box corners, sphere bottom) integrate in `obj_substep`, with the ground
  damping and friction velocity-implicit (a 6×6 solve per object).

State is (B, NO, 7) [xyz, wxyz quat] and (B, NO, 6) [linear, world
angular velocity]; the `ObjModel` is shared by every env. The humanoid's
model is shared or per env (`model_per_env`). The explicit contact
damping is clamped per object (c·dt/m < 1/2), so light props stay stable
at 450 Hz. No kernel runs here, in either package: objects live on the
exact chain only.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from benchmark.reference.frozen.maths import cross, quat_integrate, quat_rotate, quat_to_mat
from benchmark.reference.frozen.physics.model import Model, Topology, model_per_env

KIND_BOX = 0
KIND_SPHERE = 1


@dataclasses.dataclass(frozen=True)
class ObjModel:
    """Scene-object arrays (NO objects)."""

    kind: Any          # (NO,) int64, KIND_BOX | KIND_SPHERE
    half_extents: Any  # (NO, 3) box half sizes (a sphere's radius thrice)
    radius: Any        # (NO,) sphere radius (a box's smallest half size)
    mass: Any          # (NO,)
    inertia: Any       # (NO, 3) body-frame principal moments

    def nobj(self) -> int:
        return self.mass.shape[-1]


def make_obj_model(specs, device="cuda", dtype=torch.float32) -> ObjModel:
    """ObjModel from a list of {"kind": "box" | "sphere", "size": [hx, hy,
    hz] | r, "mass": m} (the array form of the reference's objs_info)."""
    kinds, he, rad, mass, inertia = [], [], [], [], []
    for s in specs:
        m = float(s.get("mass", 1.0))
        if s.get("kind", "box") == "sphere":
            r = float(np.atleast_1d(s["size"])[0])
            kinds.append(KIND_SPHERE)
            he.append([r, r, r])
            rad.append(r)
            i = 0.4 * m * r * r
            inertia.append([i, i, i])
        else:
            h = np.asarray(s["size"], np.float64).reshape(3)
            kinds.append(KIND_BOX)
            he.append(list(h))
            rad.append(float(np.min(h)))
            fx, fy, fz = (2 * h) ** 2
            inertia.append([m / 12 * (fy + fz), m / 12 * (fx + fz),
                            m / 12 * (fx + fy)])
        mass.append(m)

    def t(v, dt=dtype):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dt,
                               device=device)

    return ObjModel(kind=t(kinds, torch.int64), half_extents=t(he),
                    radius=t(rad), mass=t(mass), inertia=t(inertia))


# unit-cube corner signs
_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)], np.float32)          # (8, 3)


def _is_box(om: ObjModel, dtype) -> torch.Tensor:
    return (om.kind == KIND_BOX).to(dtype)[:, None]           # (NO, 1)


def obj_ground_terms(model: Model, om: ObjModel, pos, quat, linv, angv):
    """Ground-plane (z = 0) contact of every object: boxes at their 8
    corners, a sphere at its center less its radius (its 8 candidates
    coincide and weigh 1/8 each). The humanoid's spring, damping and
    friction constants, and the same implicit treatment of damping and
    friction: the per-point damping lumps into a 6×6 wrench W that joins
    the object's velocity solve in `obj_substep`.

    pos, linv, angv (B, NO, 3), quat (B, NO, 4) -> (F (B, NO, 3) spring
    forces, T (B, NO, 3) spring torques about the object origin, W
    (B, NO, 6, 6)), world frame."""
    dtype = pos.dtype
    m = model_per_env(model, pos.shape[0])

    def pe(x):              # (B,) leaf -> (B, 1, 1)
        return x[:, None, None]

    corners = torch.as_tensor(_CORNERS, dtype=dtype, device=pos.device)
    is_box = _is_box(om, dtype)
    local = corners[None] * om.half_extents[:, None, :] * is_box[..., None]
    wp = pos[:, :, None] + quat_rotate(quat[:, :, None], local)  # (B,NO,8,3)
    eff_z = wp[..., 2] - (1.0 - is_box) * om.radius[:, None]
    weight = is_box + (1.0 - is_box) / 8.0

    r = wp - pos[:, :, None]
    vp = linv[:, :, None] + cross(angv[:, :, None], r)
    active = (eff_z < 0.0).to(dtype) * weight
    pen = torch.minimum(torch.clamp(-eff_z, min=0.0),
                        pe(m.contact_depth_cap))
    fn = pe(m.contact_stiffness) * pen * active
    b = pe(m.contact_damping) * active
    vt = vp[..., :2]
    vt_norm = torch.sqrt((vt ** 2).sum(-1) + 1e-12)
    a = active * torch.clamp(
        pe(m.friction) * fn / torch.maximum(vt_norm, pe(m.contact_vreg)),
        max=2000.0)

    Fp = torch.cat([torch.zeros_like(vt), fn[..., None]], -1)
    F = Fp.sum(2)
    T = cross(r, Fp).sum(2)

    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
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


def _obj_sdf(om: ObjModel, pos, quat, p):
    """Signed distance of world points p (B, NO, S, 3) to each object's
    surface and the outward world unit normal, inside points included
    (box: |max(q, 0)| + min(max_i q_i, 0))."""
    R = quat_to_mat(quat)                                     # (B,NO,3,3)
    lp = torch.einsum("enij,ensi->ensj", R, p - pos[:, :, None])
    q = lp.abs() - om.half_extents[:, None]
    qpos_part = torch.clamp(q, min=0.0)
    d_out = torch.sqrt((qpos_part ** 2).sum(-1) + 1e-12)
    qmax = q.amax(-1)
    sdf_box = d_out + torch.clamp(qmax, max=0.0)
    n_out = torch.sign(lp) * qpos_part / d_out[..., None]
    inside_axis = (q == qmax[..., None]).to(p.dtype)
    n_in = torch.sign(lp) * inside_axis
    n_in = n_in / torch.sqrt((n_in ** 2).sum(-1, keepdim=True) + 1e-12)
    n_box = torch.where((qmax > 0.0)[..., None], n_out, n_in)
    ln = torch.sqrt((lp ** 2).sum(-1) + 1e-12)
    sdf_sph = ln - om.radius[:, None]
    n_sph = lp / ln[..., None]
    is_box = _is_box(om, p.dtype)
    sdf = is_box * sdf_box + (1.0 - is_box) * sdf_sph
    n_local = torch.where(is_box[..., None] > 0, n_box, n_sph)
    return sdf, torch.einsum("enij,ensj->ensi", R, n_local)


def humanoid_obj_contacts(topo: Topology, model: Model, kin: dict, vel: dict,
                          om: ObjModel, obj_pos, obj_quat, obj_linv,
                          obj_angv, k: float = 6000.0, d: float = 60.0):
    """The humanoid's SC spheres against the object primitives -> penalty
    wrenches (F_body (B, nb, 3), T_body (B, nb, 3) about body COMs,
    F_obj (B, NO, 3), T_obj (B, NO, 3) about object origins), world
    frame."""
    nb = topo.nbody
    xpos, xquat, xipos = kin["xpos"], kin["xquat"], kin["xipos"]
    B, dtype = xpos.shape[0], xpos.dtype
    m = model_per_env(model, B)
    sc = m.sc_point                                           # (B,nb,SC,3)
    SC = sc.shape[-2]
    arm = quat_rotate(xquat[:, :, None], sc)
    wc = (xpos[:, :, None] + arm).reshape(B, -1, 3)
    rad = m.sc_radius[:, :, None].expand(B, nb, SC).reshape(B, -1)
    vc = (vel["vel"][:, :, None] + cross(vel["omega"][:, :, None],
                                         arm)).reshape(B, -1, 3)

    NO = om.nobj()
    p = wc[:, None].expand(B, NO, wc.shape[1], 3)
    sdf, nvec = _obj_sdf(om, obj_pos, obj_quat, p)
    depth = rad[:, None] - sdf                                # (B,NO,S)
    act = (depth > 0.0).to(dtype)
    pt = p - nvec * rad[:, None, :, None]
    r_obj = pt - obj_pos[:, :, None]
    v_obj = obj_linv[:, :, None] + cross(obj_angv[:, :, None], r_obj)
    vrel = vc[:, None] - v_obj
    vn = (vrel * nvec).sum(-1)
    d_cl = torch.clamp(0.5 * torch.clamp(om.mass[:, None], max=1.0)
                       / m.dt[:, None, None], max=d)          # (B,NO,1)
    fn = torch.clamp(k * depth - d_cl * vn, min=0.0) * act
    vt = vrel - vn[..., None] * nvec
    vt_norm = torch.sqrt((vt ** 2).sum(-1) + 1e-12)
    a = torch.minimum(m.friction[:, None, None] * fn / torch.maximum(
        vt_norm, m.contact_vreg[:, None, None]), d_cl)
    Fp = fn[..., None] * nvec - a[..., None] * vt             # on the sphere

    F_sph = Fp.sum(1).reshape(B, nb, SC, 3)
    T_sph = cross(pt - wc[:, None], Fp).sum(1).reshape(B, nb, SC, 3)
    F_body = F_sph.sum(2)
    wc_b = wc.reshape(B, nb, SC, 3)
    T_body = (T_sph + cross(wc_b - xipos[:, :, None], F_sph)).sum(2)
    F_obj = -Fp.sum(2)
    T_obj = -cross(r_obj, Fp).sum(2)
    return F_body, T_body, F_obj, T_obj


def obj_substep(model: Model, om: ObjModel, obj_qpos, obj_qvel, F_ext,
                T_ext):
    """One 450 Hz free-body step of every object: semi-implicit Euler with
    the gyroscopic torque and velocity-implicit ground damping,
    (A0 + dt·W) v' = A0 v + dt·(f_spring + ext − gyro) with
    A0 = blockdiag(m·I, I_world); the quaternion integrates the body-frame
    angular velocity (MuJoCo's free joint). obj_qpos (B, NO, 7), obj_qvel
    (B, NO, 6), F_ext / T_ext (B, NO, 3) the humanoid's wrench (world,
    about the origin) -> (obj_qpos', obj_qvel')."""
    B = obj_qpos.shape[0]
    m = model_per_env(model, B)
    pos, quat = obj_qpos[..., :3], obj_qpos[..., 3:7]
    linv, angv = obj_qvel[..., :3], obj_qvel[..., 3:6]
    Fg, Tg, W = obj_ground_terms(m, om, pos, quat, linv, angv)
    F = F_ext + Fg + om.mass[:, None] * m.gravity[:, None]
    T = T_ext + Tg

    R = quat_to_mat(quat)
    Iw = torch.einsum("bnac,bnc,bndc->bnad", R, om.inertia.expand(
        B, -1, -1), R)
    gyro = cross(angv, torch.einsum("bnac,bnc->bna", Iw, angv))

    dt = m.dt[:, None, None]                                  # (B,1,1)
    NO = om.nobj()
    eye3 = torch.eye(3, dtype=pos.dtype, device=pos.device)
    A0 = pos.new_zeros((B, NO, 6, 6))
    A0[..., :3, :3] = om.mass[:, None, None] * eye3
    A0[..., 3:, 3:] = Iw
    rhs = (torch.einsum("bnac,bnc->bna", A0, torch.cat([linv, angv], -1))
           + dt * torch.cat([F, T - gyro], -1))
    v_new = torch.linalg.solve(A0 + dt[..., None] * W, rhs)
    linv_n, angv_n = v_new[..., :3], v_new[..., 3:]
    pos_n = pos + dt * linv_n
    w_local = torch.einsum("bnca,bnc->bna", R, angv_n)
    quat_n = quat_integrate(quat, w_local, dt)
    return (torch.cat([pos_n, quat_n], -1),
            torch.cat([linv_n, angv_n], -1))
