"""Imitation reward (PyTorch twin of uhc_tpu.rewards.reward_function):
the world_rfc_implicit family, batched.

reward_fn(topo, model, cfg, state, action, expert_lib, aux) ->
    ((B,) reward, (B, 5) per-term tensor)
evaluated at the post-step state against the expert frame
start_ind + cur_t.
"""
from __future__ import annotations

import torch

from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.maths import angvel_fd, multi_quat_diff, multi_quat_norm
from uhc_tpu_torch.physics import engine as E
from uhc_tpu_torch.smpl.constants import ee_indices


def world_rfc_implicit(topo, model, cfg, state, action, expert_lib, aux):
    exp = H.expert_at(expert_lib, state.seq_idx,
                      state.start_ind + state.cur_t)
    kin = E.fk(topo, model, state.qpos)
    B = state.qpos.shape[0]
    jpos_diffw, body_diffw = aux["jpos_diffw"], aux["body_diffw"]
    ee = torch.as_tensor(ee_indices(topo).astype("int64"),
                         device=state.qpos.device)
    cur_ee = kin["xpos"][:, ee].reshape(B, -1)
    cur_bquat = H.get_body_quat(state.qpos)
    cur_bangvel = angvel_fd(state.prev_bquat, cur_bquat, cfg.ctrl_dt)
    cur_com = kin["xipos"][:, 0]

    pose_diff = multi_quat_norm(multi_quat_diff(cur_bquat, exp["bquat"]))
    pose_diff = pose_diff * torch.cat([body_diffw.new_ones(1), body_diffw])
    pose_reward = torch.exp(-cfg.k_p * (pose_diff ** 2).sum(1))

    w = jpos_diffw[:, None]
    vel_dist = torch.linalg.vector_norm(
        (cur_bangvel.reshape(B, -1, 3) * w
         - exp["bangvel"].reshape(B, -1, 3) * w).reshape(B, -1), dim=1)
    vel_reward = torch.exp(-cfg.k_v * vel_dist ** 2)
    ee_reward = torch.exp(-cfg.k_e * ((cur_ee - exp["ee_wpos"]) ** 2).sum(1))
    com_reward = torch.exp(-cfg.k_c * ((cur_com - exp["com"]) ** 2).sum(1))

    ndof, vf_dim, _ = H.action_dims(topo, cfg)
    if cfg.residual_force and vf_dim:
        vf = action[:, ndof:ndof + vf_dim]
        vf_reward = torch.exp(-cfg.k_vf * (vf ** 2).sum(1))
    else:
        vf_reward = action.new_zeros(B)
    ws = action.new_tensor([cfg.w_p, cfg.w_v, cfg.w_e, cfg.w_c, cfg.w_vf])
    terms = torch.stack([pose_reward, vel_reward, ee_reward, com_reward,
                         vf_reward], 1)
    return (ws * terms).sum(1) / ws.sum(), terms


reward_func = {
    "world_rfc_implicit": world_rfc_implicit,
    "world_rfc_implicit_quat": world_rfc_implicit,
    "quat": world_rfc_implicit,
}


def get_reward_fn(reward_id: str):
    if reward_id not in reward_func:
        raise NotImplementedError(f"reward {reward_id!r} is not ported yet")
    return reward_func[reward_id]
