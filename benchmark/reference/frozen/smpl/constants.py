"""SMPL skeleton constants (the port's own copy of uhc_tpu.smpl.constants).

Bone orders / trees mirror the reference (uhc/smpllib/smpl_parser.py:11-231)
so that AMASS pose vectors, qpos layouts and per-joint gain tables are
interchangeable between the two frameworks.
"""
from __future__ import annotations

import numpy as np

# SMPL pose-vector joint order (pose_aa is 24*3 in this order),
# reference smpl_parser.py:11 SMPL_BONE_ORDER_NAMES.
SMPL_BONE_ORDER_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
]

# MuJoCo model body order = depth-first XML document order,
# reference smpl_parser.py:37 SMPL_BONE_KINTREE_NAMES (and the generated MJCF).
MUJOCO_BODY_ORDER = [
    "Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe", "R_Hip", "R_Knee",
    "R_Ankle", "R_Toe", "Torso", "Spine", "Chest", "Neck", "Head",
    "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand", "R_Thorax",
    "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand",
]

# Parent of each body in MUJOCO_BODY_ORDER (index into the same list, -1=root).
MUJOCO_PARENTS = np.array(
    [-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 12, 11, 14, 15, 16, 17, 11,
     19, 20, 21, 22], dtype=np.int32)

# smpl index -> mujoco index and back (smpl_mujoco.py:583 smpl_2_mujoco).
SMPL_2_MUJOCO = np.array(
    [SMPL_BONE_ORDER_NAMES.index(n) for n in MUJOCO_BODY_ORDER], dtype=np.int32)
MUJOCO_2_SMPL = np.array(
    [MUJOCO_BODY_ORDER.index(n) for n in SMPL_BONE_ORDER_NAMES], dtype=np.int32)

# SMPL kinematic parents in SMPL bone order (smplx kintree_table).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21], np.int32)

SMPL_EE_NAMES = ["L_Ankle", "R_Ankle", "L_Wrist", "R_Wrist", "Head"]
SMPL_EE_INDICES = np.array(
    [MUJOCO_BODY_ORDER.index(n) for n in SMPL_EE_NAMES], dtype=np.int32)
HEAD_INDEX = MUJOCO_BODY_ORDER.index("Head")


def ee_indices(topo) -> np.ndarray:
    """End-effector body indices for any topology carrying the SMPL body
    names (SMPL-24, SMPL-H-52, masterfoot variants)."""
    names = list(topo.body_names)
    return np.array([names.index(n) for n in SMPL_EE_NAMES], np.int32)


def head_index(topo) -> int:
    return list(topo.body_names).index("Head")


# Self-collision pairs. MuJoCo collides every non-excluded geom pair of the
# single contype/conaffinity group (smpl_parser.py:315-329); the pairs below
# are the ones that actually matter for imitation quality (crossed legs,
# arms through torso/head, hand-hand) — the curated "selected self-collision
# pairs" of SURVEY.md §7.3. Adjacent / rest-overlapping pairs are excluded
# exactly like the reference skeleton's contact excludes
# (khrylib/mocap/skeleton_mesh.py:165-218).
SELF_COLLISION_PAIR_NAMES = [
    ("L_Knee", "R_Knee"), ("L_Knee", "R_Ankle"), ("R_Knee", "L_Ankle"),
    ("L_Ankle", "R_Ankle"), ("L_Toe", "R_Toe"),
    ("L_Ankle", "R_Toe"), ("R_Ankle", "L_Toe"),
    ("L_Knee", "R_Hip"), ("R_Knee", "L_Hip"),
    ("L_Wrist", "Torso"), ("L_Wrist", "Spine"), ("L_Wrist", "Chest"),
    ("L_Wrist", "L_Hip"), ("L_Wrist", "R_Hip"), ("L_Wrist", "Head"),
    ("R_Wrist", "Torso"), ("R_Wrist", "Spine"), ("R_Wrist", "Chest"),
    ("R_Wrist", "L_Hip"), ("R_Wrist", "R_Hip"), ("R_Wrist", "Head"),
    ("L_Elbow", "Torso"), ("L_Elbow", "Spine"), ("L_Elbow", "Chest"),
    ("R_Elbow", "Torso"), ("R_Elbow", "Spine"), ("R_Elbow", "Chest"),
    ("L_Wrist", "R_Wrist"), ("L_Elbow", "R_Elbow"),
    ("L_Hand", "R_Hand"), ("L_Hand", "Torso"), ("R_Hand", "Torso"),
]


def self_collision_pairs(topo) -> np.ndarray:
    """(P, 2) int32 body-index pairs, keeping only names present in the
    topology (works for SMPL-24, SMPL-H-52, masterfoot trees)."""
    names = list(topo.body_names)
    pairs = [(names.index(a), names.index(b))
             for a, b in SELF_COLLISION_PAIR_NAMES
             if a in names and b in names]
    return np.asarray(pairs, np.int32).reshape(-1, 2)

NUM_BODIES = len(MUJOCO_BODY_ORDER)      # 24
NQ = 3 + 4 + (NUM_BODIES - 1) * 3        # 76
NV = 6 + (NUM_BODIES - 1) * 3            # 75
NDOF = (NUM_BODIES - 1) * 3              # 69 actuated dofs

# Default per-body [kp, kd, gear, torque_limit] tables
# (reference smpl_mujoco.py:67 SMPLConverter.body_params).
BODY_PARAMS = {
    "L_Hip": [500, 50, 1, 500], "L_Knee": [500, 50, 1, 500],
    "L_Ankle": [400, 40, 1, 500], "L_Toe": [200, 20, 1, 500],
    "R_Hip": [500, 50, 1, 500], "R_Knee": [500, 50, 1, 500],
    "R_Ankle": [400, 40, 1, 500], "R_Toe": [200, 20, 1, 500],
    "Torso": [1000, 100, 1, 500], "Spine": [1000, 100, 1, 500],
    "Chest": [1000, 100, 1, 500], "Neck": [100, 10, 1, 250],
    "Head": [100, 10, 1, 250], "L_Thorax": [400, 40, 1, 500],
    "L_Shoulder": [400, 40, 1, 500], "L_Elbow": [300, 30, 1, 150],
    "L_Wrist": [100, 10, 1, 150], "L_Hand": [100, 10, 1, 150],
    "R_Thorax": [400, 40, 1, 150], "R_Shoulder": [400, 40, 1, 250],
    "R_Elbow": [300, 30, 1, 150], "R_Wrist": [100, 10, 1, 150],
    "R_Hand": [100, 10, 1, 150],
}

# Per-body difference weights (reference smpl_mujoco.py:40 body_ws) — used by
# termination body-diff and reward weighting; Toes/Hands are 0.
BODY_DIFF_WEIGHTS = {
    n: 0.0 if n in ("L_Toe", "R_Toe", "L_Hand", "R_Hand") else 1.0
    for n in MUJOCO_BODY_ORDER
}


def default_jkp_jkd_torque():
    """Per-dof kp/kd/torque-limit in MuJoCo dof order (3 per non-root body),
    mirroring SMPLConverter.get_new_jkp/jkd/torque_limit
    (smpl_mujoco.py:271-281)."""
    jkp, jkd, tq, a_scale = [], [], [], []
    for name in MUJOCO_BODY_ORDER[1:]:
        p = BODY_PARAMS[name]
        jkp += [p[0]] * 3
        jkd += [p[1]] * 3
        a_scale += [p[2]] * 3
        tq += [p[3]] * 3
    return (np.array(jkp, np.float32), np.array(jkd, np.float32),
            np.array(tq, np.float32), np.array(a_scale, np.float32))


def default_diff_weights():
    """(jpos_diffw (24,), body_diffw (23,)) as in HumanoidEnv.load_models
    (humanoid_im.py:116-117)."""
    w = np.array([BODY_DIFF_WEIGHTS[n] for n in MUJOCO_BODY_ORDER], np.float32)
    return w, w[1:]
