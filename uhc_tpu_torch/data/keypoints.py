"""Keypoint-format registry and converters (the port's own copy of
uhc_tpu.data.keypoints, with a torch path where the JAX one takes jnp).

* `FORMATS[name]` — tuple of joint names in dataset order;
* `SKELETONS[name]` — (E, 2) edge list for rendering;
* `convert_kps` — one matmul `dst = P @ src` where P[(i, j)] = 1 iff dst
  joint i is src joint j; works for (T, J, C) and (J, C), any trailing
  channel count, numpy arrays or torch tensors (on their own device);
* `keypoint_hflip` — pure (returns a new array).

Registered formats: smpl, common, coco, mpii, h36m, 3dpw, spin.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

FORMATS: dict = {
    # SMPL kinematic-tree order (kp_utils.py:674)
    "smpl": (
        "hips", "leftUpLeg", "rightUpLeg", "spine", "leftLeg", "rightLeg",
        "spine1", "leftFoot", "rightFoot", "spine2", "leftToeBase",
        "rightToeBase", "neck", "leftShoulder", "rightShoulder", "head",
        "leftArm", "rightArm", "leftForeArm", "rightForeArm", "leftHand",
        "rightHand", "leftHandIndex1", "rightHandIndex1"),
    # the 14-joint "common" eval convention (kp_utils.py:379)
    "common": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop"),
    # COCO-17 (kp_utils.py:418)
    "coco": (
        "nose", "leye", "reye", "lear", "rear", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
        "rknee", "lankle", "rankle"),
    # MPII-16 (kp_utils.py:481)
    "mpii": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "hip",
        "thorax", "neck", "headtop", "rwrist", "relbow", "rshoulder",
        "lshoulder", "lelbow", "lwrist"),
    # Human3.6M 17-joint eval convention (kp_utils.py:268)
    "h36m": (
        "hip", "lhip", "lknee", "lankle", "rhip", "rknee", "rankle",
        "Spine (H36M)", "neck", "Head (H36M)", "headtop", "lshoulder",
        "lelbow", "lwrist", "rshoulder", "relbow", "rwrist"),
    # 3DPW-14 (kp_utils.py:589)
    "3dpw": (
        "nose", "thorax", "rshoulder", "relbow", "rwrist", "lshoulder",
        "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
        "lankle"),
    # SPIN / VIBE 49-joint regressor output: OpenPose-25 + SPIN-24
    # (kp_utils.py:215)
    "spin": (
        "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
        "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
        "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
        "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
        "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe",
        "OP RHeel", "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
        "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
        "neck", "headtop", "hip", "thorax", "Spine (H36M)", "Jaw (H36M)",
        "Head (H36M)", "nose", "leye", "reye", "lear", "rear"),
}

SKELETONS: dict = {
    # (kp_utils.py:702)
    "smpl": np.array(
        [[0, 1], [0, 2], [0, 3], [1, 4], [2, 5], [3, 6], [4, 7], [5, 8],
         [6, 9], [7, 10], [8, 11], [9, 12], [9, 13], [9, 14], [12, 15],
         [13, 16], [14, 17], [16, 18], [17, 19], [18, 20], [19, 21],
         [20, 22], [21, 23]]),
    # (kp_utils.py:397)
    "common": np.array(
        [[0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8], [8, 2], [8, 9],
         [9, 3], [2, 3], [8, 12], [9, 10], [12, 9], [10, 11], [12, 13]]),
}


def joint_names(fmt: str) -> Tuple[str, ...]:
    """Joint names of a registered format (get_*_joint_names twins)."""
    try:
        return FORMATS[fmt]
    except KeyError:
        raise KeyError(f"unknown keypoint format {fmt!r}; "
                       f"registered: {sorted(FORMATS)}") from None


def skeleton(fmt: str) -> np.ndarray:
    """(E, 2) edge list of a registered format (get_*_skeleton twins)."""
    return SKELETONS[fmt]


@lru_cache(maxsize=None)
def conversion(src: str, dst: str):
    """Precomputed (P, present) for dst = P @ src.

    P: (n_dst, n_src) f32 one-hot rows (zero row where dst joint is
    absent from src); present: (n_dst,) bool mask of matched joints.
    """
    s, d = joint_names(src), joint_names(dst)
    P = np.zeros((len(d), len(s)), np.float32)
    present = np.zeros(len(d), bool)
    for i, name in enumerate(d):
        if name in s:
            P[i, s.index(name)] = 1.0
            present[i] = True
    return P, present


def perm_idxs(src: str, dst: str):
    """Indices into src for the dst joints that exist there
    (kp_utils.py:41 get_perm_idxs)."""
    s, d = joint_names(src), joint_names(dst)
    return [s.index(n) for n in d if n in s]


def convert_kps(kp, src: str, dst: str):
    """Re-order keypoints from one format to another.

    kp: (..., n_src, C) with any channel count C (2D+conf, 3D, ...).
    Returns (..., n_dst, C); dst joints missing from src are zero
    (matching kp_utils.py:28, which also zero-fills). Works on numpy
    arrays or torch tensors — the conversion is a single matmul over the
    joint axis, on the tensor's device.
    """
    P, _ = conversion(src, dst)
    if isinstance(kp, np.ndarray):
        return P.astype(kp.dtype) @ kp
    import torch
    return torch.as_tensor(P, dtype=kp.dtype, device=kp.device) @ kp


def keypoint_hflip(kp, img_width: int):
    """Mirror 2D keypoints about the vertical image axis
    (kp_utils.py:19) — pure: returns a new array."""
    kp = np.array(kp, copy=True)
    kp[..., 0] = (img_width - 1.0) - kp[..., 0]
    return kp
