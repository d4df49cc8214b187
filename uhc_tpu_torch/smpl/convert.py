"""SMPL pose <-> MuJoCo-layout qpos (PyTorch twin of
uhc_tpu.smpl.convert.smpl_to_qpose / qpos_to_smpl)."""
from __future__ import annotations

import numpy as np
import torch

from uhc_tpu_torch.maths import (euler_zyx_from_quat, quat_from_euler_zyx,
                                 quat_from_rotvec, quat_to_rotvec)
from uhc_tpu_torch.smpl.constants import MUJOCO_2_SMPL, SMPL_2_MUJOCO

DEFAULT_Z = 0.91437225  # default standing height when a clip has no trans


def smpl_to_qpose(pose_aa, root_offset, trans=None, count_offset=True,
                  device="cpu") -> torch.Tensor:
    """(T, 72) SMPL axis-angle + (T, 3) trans -> (T, 76) qpos; root_offset
    is the Pelvis zero-pose offset (model body_pos[0])."""
    pose_aa = torch.as_tensor(np.asarray(pose_aa), dtype=torch.float32,
                              device=device)
    T = pose_aa.shape[0]
    if trans is None:
        trans = torch.zeros((T, 3), device=device)
        trans[:, 2] = DEFAULT_Z
    trans = torch.as_tensor(np.asarray(trans), dtype=torch.float32,
                            device=device).reshape(T, 3)
    quats = quat_from_rotvec(pose_aa.reshape(T, 24, 3))
    quats = quats[:, torch.as_tensor(SMPL_2_MUJOCO.astype(np.int64),
                                     device=device)]
    eulers = euler_zyx_from_quat(quats[:, 1:])
    ro = torch.as_tensor(np.asarray(root_offset), dtype=torch.float32,
                         device=device)
    pos = trans + ro if count_offset else trans
    return torch.cat([pos, quats[:, 0], eulers.reshape(T, -1)], 1)


def qpos_to_smpl(qpos, root_offset):
    """(T, 76) qpos -> ((T, 24, 3) SMPL axis-angle in SMPL bone order,
    (T, 3) trans); the inverse of smpl_to_qpose with count_offset."""
    qpos = torch.as_tensor(qpos, dtype=torch.float32)
    T = qpos.shape[0]
    trans = qpos[:, :3] - torch.as_tensor(np.asarray(root_offset),
                                          dtype=torch.float32,
                                          device=qpos.device)
    root_rv = quat_to_rotvec(qpos[:, 3:7])
    rv = quat_to_rotvec(quat_from_euler_zyx(qpos[:, 7:].reshape(T, 23, 3)))
    full = torch.cat([root_rv[:, None], rv], 1)          # MuJoCo order
    return full[:, torch.as_tensor(MUJOCO_2_SMPL.astype(np.int64),
                                   device=qpos.device)], trans
