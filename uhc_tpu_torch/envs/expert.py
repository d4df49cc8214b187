"""Expert motion featurization (PyTorch twin of uhc_tpu.envs.expert.qpos_fk):
per reference frame, every feature the env and reward read."""
from __future__ import annotations

import torch

from uhc_tpu_torch.maths import (angvel_fd, quat_from_euler_zyx, qvel_fd,
                                 transform_vec)
from uhc_tpu_torch.physics import engine as E
from uhc_tpu_torch.physics.model import Model, Topology
from uhc_tpu_torch.smpl.constants import ee_indices, head_index


def qpos_fk(topo: Topology, model: Model, qpos_seq: torch.Tensor,
            fps: float = 30.0) -> dict:
    """(T, nq) -> expert feature dict of (T, ...) tensors."""
    T = qpos_seq.shape[0]
    dt = 1.0 / fps
    kin = E.fk(topo, model, qpos_seq)
    wbpos, wbquat, body_com = kin["xpos"], kin["xquat"], kin["xipos"]
    joint_quats = quat_from_euler_zyx(qpos_seq[:, 7:].reshape(T, -1, 3))
    bquat = torch.cat([qpos_seq[:, None, 3:7], joint_quats], 1)
    if T > 1:
        qvel = qvel_fd(qpos_seq[:-1], qpos_seq[1:], dt)
        qvel = torch.cat([qvel[0:1], qvel], 0)
        bang = angvel_fd(bquat[:-1].reshape(T - 1, -1),
                         bquat[1:].reshape(T - 1, -1), dt)
        bang = torch.cat([bang[0:1], bang], 0)
    else:
        qvel = qpos_seq.new_zeros((1, topo.nv))
        bang = qpos_seq.new_zeros((1, topo.nbody * 3))
    qvel = torch.clamp(qvel, -10.0, 10.0)
    ee_idx = torch.as_tensor(ee_indices(topo).astype("int64"),
                             device=qpos_seq.device)
    hi = head_index(topo)
    ee_wpos = wbpos[:, ee_idx]
    root_q = qpos_seq[:, 3:7]
    ee_pos = transform_vec(ee_wpos - wbpos[:, 0:1], root_q[:, None], "root")
    rlinv = qvel[:, 0:3]
    return {
        "qpos": qpos_seq,
        "qvel": qvel,
        "wbpos": wbpos.reshape(T, -1),
        "wbquat": wbquat.reshape(T, -1),
        "bquat": bquat.reshape(T, -1),
        "body_com": body_com.reshape(T, -1),
        "rlinv": rlinv,
        "rlinv_local": transform_vec(rlinv, root_q, "root"),
        "rangv": qvel[:, 3:6],
        "bangvel": bang,
        "ee_wpos": ee_wpos.reshape(T, -1),
        "ee_pos": ee_pos.reshape(T, -1),
        "com": body_com[:, 0],
        "head_pos": wbpos[:, hi],
        "height_lb": qpos_seq[:, 2].min(),
        "head_height_lb": wbpos[:, hi, 2].min(),
        "len": T,
    }
