"""Masterfoot: the 48-body foot-model variant as a programmatic Model
transform, and bigfoot, the enlarged-feet variant of the same tree
(PyTorch twin of uhc_tpu.smpl.masterfoot masterfoot_topology /
masterfoot_model / bigfoot_model).

Reference masterfoot (uhc/smpllib/smpl_robot.py:1336 add_masterfoot,
config/masterfoot/*.yml `masterfoot: true`): each ankle body gets 12
capsule sub-bodies laid out over the foot sole (a template grid scaled by
the ankle->toe bone length), each with the ankle's 3 hinge joints
re-ranged to ±master_range degrees. The SMPLConverter remaps 24-body
clips onto the widened tree (unknown bodies: zero dofs, kp 50 / kd 5 /
torque 200, diff weight 0, smpl_mujoco.py:268-281).

The sole bodies come right after each toe, inside the ankle's subtree, so
the body order stays depth-first and every subtree stays one contiguous
index range (which the control-step kernel's sums rely on).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from uhc_tpu_torch.physics.model import Model, Topology, model_to_numpy
from uhc_tpu_torch.smpl.converter import SMPLConverter

# sole template grid in the reference's zero-pose global frame
# (smpl_robot.py:1343-1356); y is "up" in the SMPL zero pose
_TEMPLATE = np.array([
    [0, -0.15, 0],
    [-0.08, -0.15, 0.1],
    [0.08, -0.15, 0.1],
    [-0.1, -0.15, 0.2],
    [0.1, -0.15, 0.2],
    [-0.1, -0.15, 0.35],
    [0.1, -0.15, 0.35],
    [-0.1, -0.17, 0.6],
    [0.1, -0.17, 0.6],
    [0, -0.17, 0.6],
    [0.05, -0.17, 0.6],
    [-0.05, -0.17, 0.6],
])
_REF_BONE = 0.13432456960660616   # reference ankle->toe calibration length
_CAP_R, _CAP_L = 0.035, 0.1       # capsule radius / x-extent
_CAP_MASS = 1000.0 * (np.pi * _CAP_R**2 * _CAP_L
                      + 4.0 / 3.0 * np.pi * _CAP_R**3)
NUM_PER_FOOT = len(_TEMPLATE)


def _global_positions(topo: Topology, body_pos: np.ndarray) -> np.ndarray:
    g = np.zeros_like(body_pos)
    for i in range(topo.nbody):
        p = topo.parents[i]
        g[i] = body_pos[i] + (g[p] if p >= 0 else 0.0)
    return g


def masterfoot_topology(topo: Topology) -> Topology:
    """Insert 12 `{side}_Ankle_mfNN` bodies per foot, parented to the
    ankle, right after the toe (the end of the ankle's subtree in
    depth-first order, as `body.node.append` places them)."""
    names = list(topo.body_names)
    out_names, out_parent_name = [], []
    for i, n in enumerate(names):
        out_names.append(n)
        p = topo.parents[i]
        out_parent_name.append(names[p] if p >= 0 else None)
        if n in ("L_Toe", "R_Toe"):
            side = n[0]
            for k in range(NUM_PER_FOOT):
                out_names.append(f"{side}_Ankle_mf{k:02d}")
                out_parent_name.append(f"{side}_Ankle")
    parents = tuple(-1 if p is None else out_names.index(p)
                    for p in out_parent_name)
    return Topology(nbody=len(out_names), parents=parents,
                    body_names=tuple(out_names))


def masterfoot_model(topo: Topology, model: Model,
                     master_range_deg: float = 30.0):
    """(topo24, model24) -> (topo_mf, model_mf, SMPLConverter); the model
    comes back with numpy leaves."""
    new_topo = masterfoot_topology(topo)
    conv = SMPLConverter(topo, new_topo, smpl_model="smpl")
    m = model_to_numpy(model)

    names = list(topo.body_names)
    bp = m["body_pos"]
    gpos = _global_positions(topo, bp)
    cp_old, cm_old = m["contact_point"], m["contact_mask"]
    K = max(cp_old.shape[1], 3)
    SC = m["sc_point"].shape[1]

    nb = new_topo.nbody
    body_pos = np.zeros((nb, 3), np.float32)
    body_ipos = np.zeros((nb, 3), np.float32)
    body_mass = np.zeros(nb, np.float32)
    body_inertia = np.zeros((nb, 3), np.float32)
    body_iquat = np.tile([1.0, 0, 0, 0], (nb, 1)).astype(np.float32)
    cpoints = np.zeros((nb, K, 3), np.float32)
    cmask = np.zeros((nb, K), np.float32)
    sc_point = np.zeros((nb, SC, 3), np.float32)
    sc_radius = np.zeros(nb, np.float32)

    for i, name in enumerate(new_topo.body_names):
        if name in names:
            j = names.index(name)
            body_pos[i] = bp[j]
            body_ipos[i] = m["body_ipos"][j]
            body_mass[i] = m["body_mass"][j]
            body_inertia[i] = m["body_inertia"][j]
            body_iquat[i] = m["body_iquat"][j]
            cpoints[i, :cp_old.shape[1]] = cp_old[j]
            cmask[i, :cm_old.shape[1]] = cm_old[j]
            sc_point[i] = m["sc_point"][j]
            sc_radius[i] = m["sc_radius"][j]
            continue
        # a sole capsule, at zero offset from its ankle
        side = name[0]
        j_ank = names.index(f"{side}_Ankle")
        j_toe = names.index(f"{side}_Toe")
        k = int(name[-2:])
        diff_mul = np.linalg.norm(bp[j_toe]) / _REF_BONE
        t = _TEMPLATE[k].copy()
        t[2] -= 0.08 * diff_mul
        t[0] -= 0.05 * diff_mul if side == "R" else -0.05 * diff_mul
        t /= 3.0 / diff_mul
        t += gpos[j_ank]
        # sole height: the lowest foot-hull vertical coordinate (body frame
        # y + ankle global y, smpl_robot.py:1362)
        hull_y = cp_old[j_ank][cm_old[j_ank] > 0][:, 1] + gpos[j_ank][1]
        t[1] = hull_y.min()
        start = t - gpos[j_ank]          # capsule start in the ankle frame
        end = start + np.array([_CAP_L, 0.0, 0.0])
        center = 0.5 * (start + end)
        body_pos[i] = 0.0
        body_ipos[i] = center
        body_mass[i] = _CAP_MASS
        ixx = 0.5 * _CAP_MASS * _CAP_R**2
        iyy = _CAP_MASS * (_CAP_L**2 / 12.0 + _CAP_R**2 / 4.0)
        body_inertia[i] = [ixx, iyy, iyy]
        # contact proxies on the capsule underside (-y is "down" in the
        # zero-pose body frame)
        drop = np.array([0.0, _CAP_R, 0.0])
        cpoints[i, 0] = start - drop
        cpoints[i, 1] = center - drop
        cpoints[i, 2] = end - drop
        cmask[i, :3] = 1.0
        sc_point[i] = (np.linspace(0.0, 1.0, SC)[:, None] * (end - start)
                       + start)
        sc_radius[i] = _CAP_R

    armature = np.zeros(new_topo.nv, np.float32)
    armature[6:] = 0.01
    mr = np.deg2rad(master_range_deg)
    jnt_range = np.zeros((new_topo.ndof, 2), np.float32)
    old_ranges = {n: m["jnt_range"][3 * (j - 1):3 * j]
                  for j, n in enumerate(names) if j > 0}
    for i, name in enumerate(new_topo.body_names[1:], start=1):
        s = 3 * (i - 1)
        jnt_range[s:s + 3] = old_ranges[name] if name in old_ranges \
            else [-mr, mr]

    new_model = Model(**{
        **m,
        "body_pos": body_pos, "body_ipos": body_ipos,
        "body_mass": body_mass, "body_inertia": body_inertia,
        "body_iquat": body_iquat, "armature": armature,
        "jkp": conv.get_new_jkp().astype(np.float32),
        "jkd": conv.get_new_jkd().astype(np.float32),
        "torque_lim": conv.get_new_torque_limit().astype(np.float32),
        "a_scale": conv.get_new_a_scale().astype(np.float32),
        "jnt_range": jnt_range, "contact_point": cpoints,
        "contact_mask": cmask, "sc_point": sc_point,
        "sc_radius": sc_radius})
    return new_topo, new_model, conv


def bigfoot_model(topo: Topology, model: Model, scale: float = 1.6) -> Model:
    """Enlarged feet (config/bigfoot lineage): the L/R_Ankle and L/R_Toe
    bodies' contact points and inertial offsets scaled by `scale` about
    each body origin, their mass by scale³ and inertia by scale⁵; the
    tree is unchanged. Numpy leaves, the JAX package's arithmetic."""
    names = list(topo.body_names)
    feet = [names.index(n) for n in ("L_Ankle", "R_Ankle", "L_Toe", "R_Toe")]
    s = np.ones(topo.nbody, np.float32)
    s[feet] = scale
    return dataclasses.replace(
        model,
        contact_point=np.asarray(model.contact_point) * s[:, None, None],
        body_ipos=np.asarray(model.body_ipos) * s[:, None],
        body_mass=np.asarray(model.body_mass) * s**3,
        body_inertia=np.asarray(model.body_inertia) * s[:, None]**5)
