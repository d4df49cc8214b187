"""SMPL-H: the 52-body humanoid with articulated hands (PyTorch twin of
uhc_tpu.smpl.smplh smplh_topology / default_finger_offsets / smplh_model /
smplh_to_qpose / smplh_diff_weights).

Reference: uhc/smpllib/smpl_parser.py:42 SMPLH_BONE_ORDER_NAMES; per-finger
gain tables uhc/smpllib/smpl_mujoco.py:93-200 (the port's copy:
`smpl.converter.SMPLH_BODY_PARAMS` / `SMPLH_BODY_WS`).

The 52-body tree drops SMPL's L_Hand / R_Hand leaves and hangs 15 finger
segments (five chains of three) off each wrist. Pose vectors are 156 =
52 × 3 axis-angle dofs in SMPL-H native order; the MuJoCo body order is the
depth-first traversal of the joint tree with children in native order, so
every finger chain, like every subtree, is one contiguous index range.

No SMPL-H model data is in the repository, so finger joint offsets are
anthropometric chains derived from the base model's wrist->hand offset.
"""
from __future__ import annotations

import numpy as np
import torch

from uhc_tpu_torch.maths import euler_zyx_from_quat, quat_from_rotvec
from uhc_tpu_torch.physics.model import Model, Topology, model_to_numpy
from uhc_tpu_torch.smpl.convert import DEFAULT_Z
from uhc_tpu_torch.smpl.converter import SMPLH_BODY_PARAMS, SMPLH_BODY_WS

# native (pose-vector) order, reference smpl_parser.py:42
SMPLH_BONE_ORDER_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist",
] + [f"{s}_{f}{i}" for s in ("L", "R")
     for f in ("Index", "Middle", "Pinky", "Ring", "Thumb")
     for i in (1, 2, 3)]

# native-order parents: the SMPL body tree + finger chains off each wrist
_BODY_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                 16, 17, 18, 19]
SMPLH_PARENTS = np.array(
    _BODY_PARENTS
    + [20 if i == 0 else 21 + f * 3 + i for f in range(5) for i in range(3)]
    + [21 if i == 0 else 36 + f * 3 + i for f in range(5) for i in range(3)],
    np.int32)

NUM_SMPLH_BODIES = 52


def _dfs_order():
    children = {i: [] for i in range(-1, NUM_SMPLH_BODIES)}
    for i, p in enumerate(SMPLH_PARENTS):
        children[int(p)].append(i)
    order = []

    def visit(i):
        order.append(i)
        for c in children[i]:
            visit(c)

    visit(0)
    return order


SMPLH_2_MUJOCO = np.array(_dfs_order(), np.int32)      # mujoco idx -> native
MUJOCO_2_SMPLH = np.argsort(SMPLH_2_MUJOCO).astype(np.int32)
SMPLH_MUJOCO_NAMES = [SMPLH_BONE_ORDER_NAMES[i] for i in SMPLH_2_MUJOCO]
SMPLH_MUJOCO_PARENTS = np.array(
    [-1] + [int(MUJOCO_2_SMPLH[SMPLH_PARENTS[SMPLH_2_MUJOCO[i]]])
            for i in range(1, NUM_SMPLH_BODIES)], np.int32)


def smplh_topology() -> Topology:
    return Topology(nbody=NUM_SMPLH_BODIES,
                    parents=tuple(int(p) for p in SMPLH_MUJOCO_PARENTS),
                    body_names=tuple(SMPLH_MUJOCO_NAMES))


# per finger segment: small solid-cylinder mass and inertia
_FINGER_MASS = 0.02
_FINGER_INERTIA = 2e-6


def default_finger_offsets(base_model: Model, topo24: Topology) -> dict:
    """Anthropometric finger chains from the base 24-body model's
    wrist->hand offsets: four fingers fan from 60 % of the hand offset with
    a small lateral spread, the thumb roots at 25 % with an inward bias;
    distal segments continue along the hand direction."""
    names24 = list(topo24.body_names)
    bp = model_to_numpy(base_model)["body_pos"]
    spread = {"Index": 0.015, "Middle": 0.005, "Ring": -0.005,
              "Pinky": -0.015, "Thumb": 0.03}
    root_frac = {"Index": 0.6, "Middle": 0.6, "Ring": 0.58,
                 "Pinky": 0.55, "Thumb": 0.25}
    seg_len = {"Index": 0.03, "Middle": 0.032, "Ring": 0.03,
               "Pinky": 0.025, "Thumb": 0.032}
    offsets = {}
    for side in ("L", "R"):
        hand_off = bp[names24.index(f"{side}_Hand")]
        u = hand_off / max(np.linalg.norm(hand_off), 1e-6)  # along the arm
        lat = np.array([0.0, 0.0, 1.0])                     # body-frame z
        lat = lat - u * np.dot(lat, u)
        lat /= max(np.linalg.norm(lat), 1e-6)
        for f in ("Index", "Middle", "Pinky", "Ring", "Thumb"):
            offsets[f"{side}_{f}1"] = hand_off * root_frac[f] + lat * spread[f]
            offsets[f"{side}_{f}2"] = u * seg_len[f]
            offsets[f"{side}_{f}3"] = u * seg_len[f] * 0.8
    return offsets


def _params_of(name: str):
    # the reference table spells the right pinky "R_pinky"
    return SMPLH_BODY_PARAMS.get(name,
                                 SMPLH_BODY_PARAMS.get(name.replace(
                                     "Pinky", "pinky")))


def smplh_model(topo24: Topology, base_model: Model,
                finger_offsets: dict | None = None) -> Model:
    """The 52-body Model (numpy leaves) from the 24-body one: body segments
    copy their offsets, inertials and contacts; fingers get default (or
    supplied) offsets, the SMPL-H per-segment gains and a tip contact
    point. Each hand's 24-body mass less its 15 finger segments goes to
    the wrist."""
    topo = smplh_topology()
    names24 = list(topo24.body_names)
    m = model_to_numpy(base_model)
    if finger_offsets is None:
        finger_offsets = default_finger_offsets(base_model, topo24)

    nb = topo.nbody
    K = m["contact_point"].shape[1]
    SC = m["sc_point"].shape[1]
    body_pos = np.zeros((nb, 3), np.float32)
    body_ipos = np.zeros((nb, 3), np.float32)
    body_mass = np.zeros(nb, np.float32)
    body_inertia = np.zeros((nb, 3), np.float32)
    body_iquat = np.tile([1.0, 0, 0, 0], (nb, 1)).astype(np.float32)
    cpoints = np.zeros((nb, K, 3), np.float32)
    cmask = np.zeros((nb, K), np.float32)
    sc_point = np.zeros((nb, SC, 3), np.float32)
    sc_radius = np.zeros(nb, np.float32)

    for i, name in enumerate(topo.body_names):
        if name in names24:
            j = names24.index(name)
            body_pos[i] = (np.asarray(finger_offsets[name], np.float32)
                           if name in finger_offsets else m["body_pos"][j])
            body_ipos[i] = m["body_ipos"][j]
            body_mass[i] = m["body_mass"][j]
            body_inertia[i] = m["body_inertia"][j]
            body_iquat[i] = m["body_iquat"][j]
            cpoints[i] = m["contact_point"][j]
            cmask[i] = m["contact_mask"][j]
            sc_point[i] = m["sc_point"][j]
            sc_radius[i] = m["sc_radius"][j]
        else:  # finger segment
            off = np.asarray(finger_offsets[name], np.float32)
            body_pos[i] = off
            seg = np.linalg.norm(off) if name[-1] != "1" else 0.03
            body_mass[i] = _FINGER_MASS
            body_inertia[i] = _FINGER_INERTIA
            # contact point at the segment tip (about the next offset)
            cpoints[i, 0] = off / max(np.linalg.norm(off), 1e-6) * seg
            cmask[i, 0] = 1.0
            sc_point[i] = np.linspace(0.2, 0.9, SC)[:, None] * off[None, :]
            sc_radius[i] = 0.008

    for side in ("L", "R"):
        hand_mass = float(m["body_mass"][names24.index(f"{side}_Hand")])
        i_wrist = topo.body_names.index(f"{side}_Wrist")
        body_mass[i_wrist] += max(hand_mass - 15 * _FINGER_MASS, 0.0)

    jkp, jkd, tq, a_scale = [], [], [], []
    for name in topo.body_names[1:]:
        p = _params_of(name)
        jkp += [p[0]] * 3
        jkd += [p[1]] * 3
        a_scale += [p[2]] * 3
        tq += [p[3]] * 3

    armature = np.zeros(topo.nv, np.float32)
    armature[6:] = 0.01
    # joint ranges: ±pi, elbows ±4pi (smpl_parser.py:315-329)
    jnt_range = np.tile([-np.pi, np.pi], (topo.ndof, 1)).astype(np.float32)
    for i, name in enumerate(topo.body_names[1:], start=1):
        if "Elbow" in name:
            jnt_range[3 * (i - 1):3 * i] = [-4 * np.pi, 4 * np.pi]

    return Model(**{
        **m,
        "body_pos": body_pos, "body_ipos": body_ipos,
        "body_mass": body_mass, "body_inertia": body_inertia,
        "body_iquat": body_iquat, "armature": armature,
        "jkp": np.asarray(jkp, np.float32), "jkd": np.asarray(jkd, np.float32),
        "torque_lim": np.asarray(tq, np.float32),
        "a_scale": np.asarray(a_scale, np.float32),
        "jnt_range": jnt_range, "contact_point": cpoints,
        "contact_mask": cmask, "sc_point": sc_point,
        "sc_radius": sc_radius})


def smplh_to_qpose(pose_aa, root_offset, trans=None, count_offset=True,
                   device="cpu") -> torch.Tensor:
    """(T, 156) SMPL-H axis-angle (native order) + (T, 3) trans ->
    (T, 7 + 51 × 3) qpos in MuJoCo body order (smpl_to_qpose with
    model='smplh', smpl_mujoco.py:543)."""
    pose_aa = torch.as_tensor(np.asarray(pose_aa), dtype=torch.float32,
                              device=device)
    T = pose_aa.shape[0]
    if trans is None:
        trans = torch.zeros((T, 3), device=device)
        trans[:, 2] = DEFAULT_Z
    trans = torch.as_tensor(np.asarray(trans), dtype=torch.float32,
                            device=device).reshape(T, 3)
    quats = quat_from_rotvec(pose_aa.reshape(T, NUM_SMPLH_BODIES, 3))
    quats = quats[:, torch.as_tensor(SMPLH_2_MUJOCO.astype(np.int64),
                                     device=device)]
    eulers = euler_zyx_from_quat(quats[:, 1:])
    ro = torch.as_tensor(np.asarray(root_offset), dtype=torch.float32,
                         device=device)
    pos = trans + ro if count_offset else trans
    return torch.cat([pos, quats[:, 0], eulers.reshape(T, -1)], 1)


def smplh_diff_weights():
    """(jpos_diffw (52,), body_diffw (51,)) from SMPLH_BODY_WS: finger
    segments 0.3, toes 0."""
    def w_of(name):
        if name == "Pelvis":
            return 1.0
        return SMPLH_BODY_WS.get(name,
                                 SMPLH_BODY_WS.get(name.replace("Pinky",
                                                                "pinky")))

    w = np.array([w_of(n) for n in SMPLH_MUJOCO_NAMES], np.float32)
    return w, w[1:]
