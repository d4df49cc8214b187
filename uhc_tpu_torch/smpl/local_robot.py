"""The robot variants of smpl_local_robot / smpl_cap_robot as array
transforms over (Topology, Model) (PyTorch port's copy of
uhc_tpu.smpl.local_robot; reference uhc/smpllib/smpl_local_robot.py:1136
and smpl_cap_robot.py).

Each option is a pure function of the model's arrays, numpy in and out
(a model of tensors is read through `numpy_model`), with the same field
names and the same float32 results as the JAX package:

* upright_start_model -- every body-frame vector rotated by base_rot, so
  the zero pose stands upright (configs then use an identity base_rot);
* big_ankle_model -- the ankles' contact points and self-collision radii
  scaled;
* box_feet_model -- an ankle's contact points replaced by the 8 corners of
  their bounding box;
* capsule_model -- every body's contact points collapsed onto the two
  ends of its self-collision sphere chain;
* remove_toe_model -- the Toe bodies dropped from the tree (24 -> 22
  bodies), their mass and contact points folded into the ankles.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from uhc_tpu_torch.physics.model import Model, Topology, numpy_model


def _arrays(model: Model) -> dict:
    return {f.name: np.asarray(getattr(model, f.name))
            for f in dataclasses.fields(Model)}


def _rotate_all(v: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Rotate (..., 3) vectors by the quaternion q = (w, x, y, z)."""
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return v @ R.T


def upright_start_model(model: Model,
                        base_rot=(0.7071, 0.7071, 0.0, 0.0)) -> Model:
    """Every body-frame vector pre-rotated by base_rot, so that the zero
    pose is upright (smpl_local_robot `upright_start`); configs using this
    model take an identity base_rot."""
    model = numpy_model(model)
    m = _arrays(model)
    q = np.asarray(base_rot, np.float64)
    q = q / np.linalg.norm(q)

    def rot(a):
        return _rotate_all(np.asarray(a, np.float64), q).astype(np.float32)

    return dataclasses.replace(
        model, body_pos=rot(m["body_pos"]), body_ipos=rot(m["body_ipos"]),
        contact_point=rot(m["contact_point"]), sc_point=rot(m["sc_point"]))


def big_ankle_model(topo: Topology, model: Model,
                    scale: float = 1.5) -> Model:
    """The ankles' collision geometry scaled (smpl_local_robot
    `big_ankle`)."""
    model = numpy_model(model)
    m = _arrays(model)
    names = list(topo.body_names)
    s = np.ones(topo.nbody, np.float32)
    for n in ("L_Ankle", "R_Ankle"):
        if n in names:
            s[names.index(n)] = scale
    return dataclasses.replace(
        model, contact_point=m["contact_point"] * s[:, None, None],
        sc_radius=m["sc_radius"] * s)


def box_feet_model(topo: Topology, model: Model) -> Model:
    """An ankle's contact points replaced by the 8 corners of their
    bounding box (the box-geom feet)."""
    model = numpy_model(model)
    m = _arrays(model)
    names = list(topo.body_names)
    cp = m["contact_point"].copy()
    cm = m["contact_mask"].copy()
    for n in ("L_Ankle", "R_Ankle"):
        if n not in names:
            continue
        i = names.index(n)
        pts = cp[i][cm[i] > 0]
        lo, hi = pts.min(0), pts.max(0)
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])], np.float32)
        cp[i] = 0.0
        cm[i] = 0.0
        cp[i, :8] = corners
        cm[i, :8] = 1.0
    return dataclasses.replace(model, contact_point=cp, contact_mask=cm)


def capsule_model(topo: Topology, model: Model) -> Model:
    """The capsule-only collision family (smpl_cap_robot): each body's
    contact candidates are the two ends of its self-collision sphere
    chain, dropped by the chain's radius along -y (down in the zero
    pose)."""
    model = numpy_model(model)
    m = _arrays(model)
    sc, r = m["sc_point"], m["sc_radius"]
    cp = np.zeros_like(m["contact_point"])
    cm = np.zeros_like(m["contact_mask"])
    for i in range(topo.nbody):
        ends = np.stack([sc[i, 0], sc[i, -1]])
        cp[i, :2] = ends - np.array([0.0, r[i], 0.0])
        cm[i, :2] = 1.0
    return dataclasses.replace(model, contact_point=cp, contact_mask=cm)


def remove_toe_model(topo: Topology, model: Model) -> Tuple[Topology, Model]:
    """The Toe bodies dropped; each toe's mass and contact points fold into
    its ankle (the points translated by the toe's offset, filling the
    ankle's free contact slots), so the foot keeps its support
    (smpl_local_robot `remove_toe`). Body order stays depth-first."""
    names = list(topo.body_names)
    keep = [i for i, n in enumerate(names) if n not in ("L_Toe", "R_Toe")]
    old2new = {o: n for n, o in enumerate(keep)}
    new_topo = Topology(
        nbody=len(keep),
        parents=tuple(-1 if topo.parents[o] == -1
                      else old2new[topo.parents[o]] for o in keep),
        body_names=tuple(names[o] for o in keep))

    model = numpy_model(model)
    m = _arrays(model)
    arr = {f: m[f].copy() for f in (
        "body_pos", "body_ipos", "body_mass", "body_inertia", "body_iquat",
        "contact_point", "contact_mask", "sc_point", "sc_radius",
        "jkp", "jkd", "torque_lim", "a_scale", "jnt_range")}
    K = arr["contact_point"].shape[1]
    for side in ("L", "R"):
        if f"{side}_Toe" not in names:
            continue
        it, ia = names.index(f"{side}_Toe"), names.index(f"{side}_Ankle")
        off = arr["body_pos"][it]
        m_t, m_a = arr["body_mass"][it], arr["body_mass"][ia]
        arr["body_ipos"][ia] = (
            m_a * arr["body_ipos"][ia]
            + m_t * (off + arr["body_ipos"][it])) / (m_a + m_t)
        arr["body_mass"][ia] = m_a + m_t
        tpts = arr["contact_point"][it][arr["contact_mask"][it] > 0] + off
        napts = int(arr["contact_mask"][ia].sum())
        free = K - napts
        take = min(len(tpts), free) if free > 0 else 0
        if take:
            arr["contact_point"][ia, napts:napts + take] = tpts[:take]
            arr["contact_mask"][ia, napts:napts + take] = 1.0

    dof = np.concatenate([np.arange(3 * (o - 1), 3 * o)
                          for o in keep if o > 0])
    armature = np.zeros(new_topo.nv, np.float32)
    armature[6:] = m["armature"][6:6 + new_topo.ndof]
    new_model = dataclasses.replace(
        model,
        **{f: arr[f][keep] for f in (
            "body_pos", "body_ipos", "body_mass", "body_inertia",
            "body_iquat", "contact_point", "contact_mask", "sc_point",
            "sc_radius")},
        **{f: arr[f][dof] for f in (
            "jkp", "jkd", "torque_lim", "a_scale", "jnt_range")},
        armature=armature)
    return new_topo, new_model
