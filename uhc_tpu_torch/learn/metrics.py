"""Evaluation metrics (numpy twin of uhc_tpu.learn.metrics.compute_metrics).

Reference: uhc/smpllib/smpl_eval.py:65 compute_metrics with the same
definitions and mm/×1000 scales:
  succ        not fail_safe and percent == 1 (with a one-ulp guard)
  mpjpe       root-relative joint position error (mm)
  pa_mpjpe    after per-frame Procrustes alignment (mm)
  mpjpe_g     global joint position error (mm)
  root_dist   Frobenius norm of 4x4 root-pose difference ×1000
  vel_dist    per-frame joint displacement difference (mm/frame)
  accel_dist  second-difference error (mm/frame²)
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _quat_to_mat_np(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = np.where(n > 0, 2.0 / np.maximum(n, 1e-12), 0.0)
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - s * (y * y + z * z)
    m[..., 0, 1] = s * (x * y - w * z)
    m[..., 0, 2] = s * (x * z + w * y)
    m[..., 1, 0] = s * (x * y + w * z)
    m[..., 1, 1] = 1 - s * (x * x + z * z)
    m[..., 1, 2] = s * (y * z - w * x)
    m[..., 2, 0] = s * (x * z - w * y)
    m[..., 2, 1] = s * (y * z + w * x)
    m[..., 2, 2] = 1 - s * (x * x + y * y)
    return m


def root_matrices(qpos):
    T = qpos.shape[0]
    mats = np.tile(np.eye(4), (T, 1, 1))
    mats[:, :3, :3] = _quat_to_mat_np(qpos[:, 3:7])
    mats[:, :3, 3] = qpos[:, :3]
    return mats


def frobenious_norm(a, b):
    """Mean ||A @ B⁻¹ - I||_F (smpl_eval.py get_frobenious_norm)."""
    binv = np.linalg.inv(b)
    d = np.matmul(a, binv) - np.eye(4)
    return np.mean(np.linalg.norm(d.reshape(d.shape[0], -1), axis=1))


def procrustes_mpjpe(pred, gt):
    """Per-frame similarity-aligned MPJPE (smpl_eval.py:24 p_mpjpe)."""
    muX = gt.mean(axis=1, keepdims=True)
    muY = pred.mean(axis=1, keepdims=True)
    X0, Y0 = gt - muX, pred - muY
    normX = np.sqrt((X0**2).sum(axis=(1, 2), keepdims=True))
    normY = np.sqrt((Y0**2).sum(axis=(1, 2), keepdims=True))
    X0, Y0 = X0 / normX, Y0 / normY
    H = X0.transpose(0, 2, 1) @ Y0
    U, s, Vt = np.linalg.svd(H)
    V = Vt.transpose(0, 2, 1)
    R = V @ U.transpose(0, 2, 1)
    sign = np.sign(np.linalg.det(R))[:, None]
    V[:, :, -1] *= sign
    s[:, -1] *= sign.ravel()
    R = V @ U.transpose(0, 2, 1)
    tr = s.sum(axis=1)[:, None, None]
    a = tr * normX / normY
    t = muX - a * (muY @ R)
    aligned = a * (pred @ R) + t
    return np.linalg.norm(aligned - gt, axis=-1)


def compute_metrics(pred_qpos, gt_qpos, pred_jpos, gt_jpos,
                    fail_safe: bool, percent: float) -> Dict[str, float]:
    """All inputs (T, ...) numpy; jpos (T, nb, 3) in any consistent order
    with the root at index 0."""
    pred_jpos = pred_jpos.reshape(pred_jpos.shape[0], -1, 3)
    gt_jpos = gt_jpos.reshape(gt_jpos.shape[0], -1, 3)

    root_dist = frobenious_norm(root_matrices(pred_qpos),
                                root_matrices(gt_qpos)) * 1000

    vel = np.linalg.norm(np.diff(pred_jpos, axis=0) - np.diff(gt_jpos, axis=0),
                         axis=2)
    vel_dist = vel.mean() * 1000 if len(vel) else 0.0
    acc_p = pred_jpos[:-2] - 2 * pred_jpos[1:-1] + pred_jpos[2:]
    acc_g = gt_jpos[:-2] - 2 * gt_jpos[1:-1] + gt_jpos[2:]
    accel_dist = (np.linalg.norm(acc_p - acc_g, axis=2).mean() * 1000
                  if len(acc_p) else 0.0)

    mpjpe_g = np.linalg.norm(pred_jpos - gt_jpos, axis=2).mean() * 1000
    p_rel = pred_jpos - pred_jpos[:, 0:1]
    g_rel = gt_jpos - gt_jpos[:, 0:1]
    mpjpe = np.linalg.norm(p_rel - g_rel, axis=2).mean() * 1000
    pa_mpjpe = procrustes_mpjpe(p_rel, g_rel).mean() * 1000

    return {
        # 1-ulp tolerance: an f32 cur_t/(wlen-1) computed as a
        # reciprocal-multiply can land one ulp below 1.0 (e.g. 209/209 ->
        # 0.99999994), which an exact >= 1.0 reads as a truncated clip
        # (reference smpl_eval.py:101 compares == 1 in f64)
        "succ": float((not fail_safe) and percent >= 1.0 - 1e-5),
        "mpjpe": float(mpjpe),
        "pa_mpjpe": float(pa_mpjpe),
        "mpjpe_g": float(mpjpe_g),
        "root_dist": float(root_dist),
        "vel_dist": float(vel_dist),
        "accel_dist": float(accel_dist),
    }


def compute_penetration_skate_vertices(verts: np.ndarray,
                                       floor_z: float = 0.0
                                       ) -> Dict[str, float]:
    """Vertex penetration and skate (reference smpl_eval.py:125
    compute_penetration, :138 compute_skate), in mm. verts: (T, V, 3)
    mesh vertices of the predicted motion."""
    z = verts[..., 2] - floor_z
    pen = []
    for zt in z:
        pind = zt < 0
        pen.append(float(-zt[pind].mean() * 1000) if pind.any() else 0.0)
    skate = []
    for t in range(verts.shape[0] - 1):
        cind = (z[t] <= 0) & (z[t + 1] <= 0)
        if cind.any():
            off = verts[t + 1, cind, :2] - verts[t, cind, :2]
            skate.append(float(np.linalg.norm(off, axis=1).mean() * 1000))
        else:
            skate.append(0.0)
    return {"penetration": float(np.mean(pen)) if pen else 0.0,
            "skate": float(np.mean(skate)) if skate else 0.0}


def vertices_from_qpos(pred_qpos: np.ndarray, smpl_data, betas,
                       root_offset, chunk: int = 64) -> np.ndarray:
    """(T, nq) qpos -> (T, V, 3) mesh vertices via the pose's inverse and
    LBS, in chunks of frames (the reference eval's pred_vertices): the
    24-body euler qpos (76 wide) through qpos_to_smpl, the ball family's
    (99, uhc_tpu/learn/metrics.py:171-175) through qpos_ball_to_smpl, the
    52-body SMPL-H's (160) through qpos_to_smplh on 52-joint model data."""
    from uhc_tpu_torch.smpl.convert import qpos_ball_to_smpl, qpos_to_smpl
    from uhc_tpu_torch.smpl.lbs import lbs
    from uhc_tpu_torch.smpl.smplh import qpos_to_smplh

    inverse = {76: qpos_to_smpl, 99: qpos_ball_to_smpl,
               160: qpos_to_smplh}[np.shape(pred_qpos)[-1]]
    pose_aa, trans = inverse(np.asarray(pred_qpos, np.float32), root_offset)
    betas = np.asarray(betas, np.float32)
    out = [lbs(smpl_data, pose_aa[i:i + chunk], betas,
               trans[i:i + chunk])[0].numpy()
           for i in range(0, pose_aa.shape[0], chunk)]
    return np.concatenate(out, 0)
