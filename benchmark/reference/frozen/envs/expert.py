"""Expert motion featurization (PyTorch twin of uhc_tpu.envs.expert
qpos_fk and qpos_fk_frame): per reference frame, every feature the env and
reward read, and the single-frame targets of the kin env."""
from __future__ import annotations

import torch

from benchmark.reference.frozen.maths import (angvel_fd, quat_from_euler_zyx, qvel_fd,
                                 qvel_fd_ball, transform_vec)
from benchmark.reference.frozen.physics import engine as E
from benchmark.reference.frozen.physics.model import Model, Topology
from benchmark.reference.frozen.smpl.constants import ee_indices, head_index


def qpos_fk(topo: Topology, model: Model, qpos_seq: torch.Tensor,
            fps: float = 30.0) -> dict:
    """(T, nq) -> expert feature dict of (T, ...) tensors; a ball-joint
    tree's qpos holds its joint quaternions (qvel from `qvel_fd_ball`)."""
    T = qpos_seq.shape[0]
    dt = 1.0 / fps
    kin = E.fk(topo, model, qpos_seq)
    wbpos, wbquat, body_com = kin["xpos"], kin["xquat"], kin["xipos"]
    ball = topo.joint_kind == "ball"
    joint_quats = (qpos_seq[:, 7:].reshape(T, -1, 4) if ball else
                   quat_from_euler_zyx(qpos_seq[:, 7:].reshape(T, -1, 3)))
    bquat = torch.cat([qpos_seq[:, None, 3:7], joint_quats], 1)
    if T > 1:
        qvel = (qvel_fd_ball if ball else qvel_fd)(qpos_seq[:-1],
                                                   qpos_seq[1:], dt)
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


def qpos_fk_frame(topo: Topology, model: Model, qpos: torch.Tensor) -> dict:
    """Single-frame FK targets of a batch of poses (B, nq) (twin of
    uhc_tpu.envs.expert.qpos_fk_frame, the kin env's target of
    humanoid_kin_v1.py:307): no velocity fields. `model` is shared or per
    env."""
    B = qpos.shape[0]
    kin = E.fk(topo, model, qpos)
    jq = quat_from_euler_zyx(qpos[:, 7:].reshape(B, -1, 3))
    bquat = torch.cat([qpos[:, None, 3:7], jq], 1)
    ee_idx = torch.as_tensor(ee_indices(topo).astype("int64"),
                             device=qpos.device)
    hi = head_index(topo)
    return {
        "qpos": qpos,
        "wbpos": kin["xpos"].reshape(B, -1),
        "wbquat": kin["xquat"].reshape(B, -1),
        "bquat": bquat.reshape(B, -1),
        "body_com": kin["xipos"].reshape(B, -1),
        "ee_wpos": kin["xpos"][:, ee_idx].reshape(B, -1),
        "head_pose": torch.cat([kin["xpos"][:, hi], kin["xquat"][:, hi]], 1),
    }
