"""Supervised kinematic losses (PyTorch twin of uhc_tpu.learn.losses,
reference uhc/losses/loss_function.py:96-202). Every function takes
(..., D) batched tensors and returns a per-sample loss of shape (...,);
means are taken at the call site, as in KinNet.compute_loss. Plain torch
ops, so autograd differentiates them.

qpos layout: [trans(3), root quat(4), 23×3 euler]: root position [..., :3],
root quaternion [..., 3:7], body rotation [..., 7:].
"""
from __future__ import annotations

import torch

from uhc_tpu_torch.maths import quat_inv, quat_mul


def quat_diff(gt_quat, pred_quat):
    """Relative quaternion gt ⊗ pred⁻¹."""
    return quat_mul(gt_quat, quat_inv(pred_quat))


def orientation_loss(gt_quat, pred_quat):
    """‖|q_rel| − identity‖²."""
    dist = quat_diff(gt_quat, pred_quat)
    iden = torch.zeros_like(dist)
    iden[..., 0] = 1.0
    return ((dist.abs() - iden) ** 2).sum(-1)


def pose_rot_loss(gt_pose, pred_pose):
    """Squared euler-angle body-pose error."""
    return ((gt_pose[..., 7:] - pred_pose[..., 7:]) ** 2).sum(-1)


def root_pos_loss(gt_pose, pred_pose):
    return ((gt_pose[..., :3] - pred_pose[..., :3]) ** 2).sum(-1)


def root_orientation_loss(gt_pose, pred_pose):
    return orientation_loss(gt_pose[..., 3:7], pred_pose[..., 3:7])


def end_effector_pos_loss(gt_pos, pred_pos):
    """Everything past the batch axis flattened before the sum (the
    reference's `.reshape(gt_pos.shape[0], -1)`): one scalar a row."""
    d = (gt_pos - pred_pos).reshape(gt_pos.shape[0], -1)
    return (d ** 2).sum(-1)


def position_loss(gt_pos, pred_pos):
    return ((gt_pos - pred_pos) ** 2).sum(-1)


def action_loss(gt_action, pred_action):
    return ((gt_action - pred_action) ** 2).sum(-1)


def velocity_distance_loss(gt_vel, pred_vel):
    return ((gt_vel - pred_vel) ** 2).sum(-1)


def linear_velocity_loss(gt_vel, pred_vel):
    return ((gt_vel[..., :3] - pred_vel[..., :3]) ** 2).sum(-1)


def angular_velocity_loss(gt_vel, pred_vel):
    return ((gt_vel[..., 3:6] - pred_vel[..., 3:6]) ** 2).sum(-1)


def deep_mimic_loss(gt_pose, pred_pose, gt_vel, pred_vel, w):
    """DeepMimicLoss; `w` maps w_p / w_vl / w_va / w_ee / w_rp / w_rr."""
    rp = root_pos_loss(gt_pose, pred_pose)
    rr = root_orientation_loss(gt_pose, pred_pose)
    p = pose_rot_loss(gt_pose, pred_pose)
    vl = linear_velocity_loss(gt_vel, pred_vel)
    va = angular_velocity_loss(gt_vel, pred_vel)
    loss = (w["w_rp"] * rp + w["w_rr"] * rr + w["w_p"] * p
            + w["w_vl"] * vl + w["w_va"] * va)
    terms = [rp.mean(), rr.mean(), p.mean(), vl.mean(), va.mean(),
             loss.new_zeros(())]
    return loss.mean(), terms


def traj_loss(gt_pose, pred_pose, gt_vel, pred_vel, w):
    """TrajLoss: DeepMimicLoss without the pose term."""
    rp = root_pos_loss(gt_pose, pred_pose)
    rr = root_orientation_loss(gt_pose, pred_pose)
    vl = linear_velocity_loss(gt_vel, pred_vel)
    va = angular_velocity_loss(gt_vel, pred_vel)
    loss = w["w_rp"] * rp + w["w_rr"] * rr + w["w_vl"] * vl + w["w_va"] * va
    terms = [rp.mean(), rr.mean(), loss.new_zeros(()), vl.mean(), va.mean(),
             loss.new_zeros(())]
    return loss.mean(), terms


def pose_loss_masked(gt_pose, pred_pose, ofpos: int = 7):
    """PoseLoss. The reference zeroes an all-zero mask (mask[:, 0:ofpos] =
    0.0), so the loss is identically 0; kept as it is."""
    mask = torch.zeros_like(pred_pose)
    mask[..., 0:ofpos] = 0.0
    diff = (gt_pose - pred_pose) * mask
    return (diff ** 2).sum(-1).mean()
