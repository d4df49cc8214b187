"""Batched SMPL-side FK with camera-projection fitting losses (PyTorch twin
of uhc_tpu.smpl.humanoid_batch).

FK runs in MuJoCo body order over per-body offsets derived from the shaped
SMPL joints; `CameraFit.proj2d` maps MuJoCo bodies -> SMPL joints -> the
OpenPose subset, projects with the full-frame camera (R, t, K), then
merges to the 14-point OP skeleton via `smpl_op_to_op`. The losses are
plain tensor functions: `torch.autograd` gives their gradients where the
JAX package takes `jax.grad`, and the zero pose's gradient stays finite
(`maths.quat_from_rotvec` is small-angle safe).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from uhc_tpu_torch.maths import (cross, quat_from_rotvec, quat_mul,
                                 quat_rotate)
from uhc_tpu_torch.smpl.constants import (MUJOCO_2_SMPL, MUJOCO_PARENTS,
                                          SMPL_2_MUJOCO)


def smpl_op_to_op(j2d: torch.Tensor) -> torch.Tensor:
    """Merge the OpenPose-25-style subset to the 14-point OP skeleton."""
    return torch.cat([
        j2d[..., [1, 4], :].mean(-2, keepdim=True),
        j2d[..., 1:7, :],
        j2d[..., [7, 8, 11], :].mean(-2, keepdim=True),
        j2d[..., 9:11, :],
        j2d[..., 12:, :],
    ], -2)


def normalize_screen_coordinates(x, w: float = 1920, h: float = 1080):
    """[0, w] × [0, h] -> [-1, 1] × aspect-preserving."""
    return x / w * 2 - torch.tensor([1.0, h / w], dtype=x.dtype,
                                    device=x.device)


def fk_batch(offsets: torch.Tensor, pose_aa: torch.Tensor,
             trans: torch.Tensor, count_offset: bool = True) -> dict:
    """FK over MuJoCo-ordered per-body offsets.

    offsets: (24, 3) local body offsets (MuJoCo order); pose_aa: (..., 72)
    axis-angle in SMPL order; trans: (..., 3) root translation. Returns
    {"wbpos": (..., 24, 3), "wbquat": (..., 24, 4)} on their device."""
    aa = pose_aa.reshape(pose_aa.shape[:-1] + (24, 3))
    quats = quat_from_rotvec(aa)[..., torch.as_tensor(
        SMPL_2_MUJOCO.astype(np.int64), device=aa.device), :]
    root = trans + offsets[0] if count_offset else trans
    gq = [quats[..., 0, :]]
    gp = [root]
    for i in range(1, 24):
        p = int(MUJOCO_PARENTS[i])
        gp.append(gp[p] + quat_rotate(gq[p], offsets[i].expand(
            gp[p].shape)))
        gq.append(quat_mul(gq[p], quats[..., i, :]))
    return {"wbpos": torch.stack(gp, -2), "wbquat": torch.stack(gq, -2)}


@dataclasses.dataclass
class CameraFit:
    """Projection state and the fitting losses. The losses take
    `input_vec` (..., 75) = [trans (3), pose_aa (72)]; every tensor lives
    on `device` (float32)."""

    offsets: Any                 # (24, 3) mujoco-order body offsets
    full_R: Any                  # (3, 3)
    full_t: Any                  # (3,)
    K: Any                       # (3, 3)
    img_w: float
    img_h: float
    smpl2op_map: Any             # (J_op,) SMPL joint -> OP index map
    device: Any = "cpu"
    gt_2d_joints: Any = None     # (T, J2d, 2)
    inliers: Any = None          # (T, J2d, 2) bool
    weighting: Any = None        # (T, J2d, 2) exp-decay frame weights

    def _t(self, x):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.offsets = self._t(self.offsets)
        self.full_R, self.full_t, self.K = (self._t(x) for x in (
            self.full_R, self.full_t, self.K))
        m = np.asarray(self.smpl2op_map)
        self.smpl2op_partial = torch.as_tensor(m[m < 22].astype(np.int64),
                                               device=self.device)
        self._m2s = torch.as_tensor(MUJOCO_2_SMPL.astype(np.int64),
                                    device=self.device)

    def update_tgt_joints(self, tgt_joints, inliers, lam: float = 0.3):
        """Target pixels (T, J, 2), their inlier mask, the frame weights
        exp(-lam·t) normalized, the normalized targets and the unit camera
        rays K⁻¹ [u, v, 1]."""
        self.gt_2d_joints = self._t(tgt_joints)
        self.inliers = (inliers.bool() if isinstance(inliers, torch.Tensor)
                        else torch.as_tensor(np.asarray(inliers, bool))
                        ).to(self.device)
        T, J = self.gt_2d_joints.shape[0], self.gt_2d_joints.shape[-2]
        w = np.exp(lam * -np.arange(T))
        w = w / w.sum()
        self.weighting = self._t(np.tile(w[:, None, None], [1, J, 2]))
        self.gt_2d_norm = normalize_screen_coordinates(
            self.gt_2d_joints, self.img_w, self.img_h)
        rays = torch.cat([self.gt_2d_joints,
                          self.gt_2d_joints.new_ones((T, J, 1))], 2) \
            @ torch.linalg.inv(self.K).T
        self.camera_rays = rays / torch.linalg.norm(rays, dim=2,
                                                    keepdim=True)

    # -- projection -------------------------------------------------------
    def proj2d(self, wbpos, return_cam_3d: bool = False):
        """(..., 24, 3) mujoco bodies -> (..., 14, 2) OP pixels."""
        j3d = wbpos[..., self._m2s, :]
        j3d = j3d[..., self.smpl2op_partial, :]
        cam = j3d @ self.full_R.T + self.full_t
        j2d = cam @ self.K.T
        j2d = j2d[..., :2] / j2d[..., 2:]
        j2d = smpl_op_to_op(j2d)
        return (j2d, cam) if return_cam_3d else j2d

    def _fk(self, input_vec):
        return fk_batch(self.offsets, input_vec[..., 3:],
                        input_vec[..., :3])["wbpos"]

    def _compare(self, j2d, ord: int, normalize: bool):
        if normalize:
            pred = normalize_screen_coordinates(j2d, self.img_w, self.img_h)
            gt = self.gt_2d_norm
        else:
            pred, gt = j2d, self.gt_2d_joints
        if ord == 1:
            return torch.mean(torch.abs((gt - pred) * self.inliers))
        w = self.weighting * self.inliers
        return torch.mean(torch.sum((gt - pred) ** 2 * w, 0))

    # -- losses -------------------------------------------------------------
    def proj_2d_loss(self, input_vec, ord: int = 2, normalize: bool = True):
        return self._compare(self.proj2d(self._fk(input_vec)), ord,
                             normalize)

    def proj_2d_body_loss(self, input_vec, ord: int = 2,
                          normalize: bool = False):
        """Root-centred variant: the prediction moved onto the target's
        mid-hip before comparing."""
        j2d = self.proj2d(self._fk(input_vec))
        center = self.gt_2d_joints[..., 7:8, :]
        return self._compare(j2d + (center - j2d[..., 7:8, :]), ord,
                             normalize)

    def proj_2d_root_loss(self, root_pos_rot):
        """Mid-hip-only loss over the 6-dim root."""
        input_vec = torch.cat([root_pos_rot.reshape(1, 6),
                               root_pos_rot.new_zeros((1, 69))], 1)
        j2d = self.proj2d(self._fk(input_vec))
        return torch.mean(torch.abs(self.gt_2d_joints[..., 7:8, :]
                                    - j2d[..., 7:8, :]))

    def proj_2d_line_loss(self, input_vec):
        """Distance of camera-space joints to the target pixel rays (the
        targets must count as many joints as the projected subset)."""
        _, cam = self.proj2d(self._fk(input_vec), return_cam_3d=True)
        return torch.mean(cross(cam, cam - self.camera_rays) ** 2)


def loss_and_grad(loss_fn, x: torch.Tensor):
    """(loss, d loss / d x) of a loss of one tensor, by autograd."""
    x = x.detach().requires_grad_(True)
    loss = loss_fn(x)
    (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), g


def descend(loss_fn, x0: torch.Tensor, lr: float, steps: int):
    """`steps` plain gradient steps x <- x - lr·∇loss; returns (the loss
    before each step, the gradient at each step, the final x)."""
    x = x0.detach()
    losses, grads = [], []
    for _ in range(steps):
        loss, g = loss_and_grad(loss_fn, x)
        losses.append(loss)
        grads.append(g)
        x = x - lr * g
    return torch.stack(losses), torch.stack(grads), x
