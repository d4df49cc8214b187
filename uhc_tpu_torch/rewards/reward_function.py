"""Imitation reward (PyTorch twin of uhc_tpu.rewards.reward_function):
the world_rfc_implicit and world_rfc_explicit families, batched.

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
from uhc_tpu_torch.physics import solver as S
from uhc_tpu_torch.smpl.constants import ee_indices


def _terms(topo, model, cfg, state, expert_lib, aux, explicit: bool):
    """The pose, velocity, end-effector and COM terms (B,) each. The
    explicit family (uhc_tpu/rewards/reward_function.py:82
    _explicit_terms) differs in the velocity term alone: no jpos_diffw
    weights, the expert's angular velocity zeroed past the sequence end,
    and the norm order v_ord."""
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

    if explicit:
        past_end = (state.start_ind + state.cur_t) >= exp["len"]
        d = cur_bangvel - torch.where(past_end[:, None], 0.0,
                                      exp["bangvel"])
        v_ord = cfg.rw("v_ord", 2)
        vel_dist = (torch.linalg.vector_norm(d, dim=1) if v_ord == 2
                    else (d.abs() ** v_ord).sum(1) ** (1.0 / v_ord))
    else:
        w = jpos_diffw[:, None]
        vel_dist = torch.linalg.vector_norm(
            (cur_bangvel.reshape(B, -1, 3) * w
             - exp["bangvel"].reshape(B, -1, 3) * w).reshape(B, -1), dim=1)
    vel_reward = torch.exp(-cfg.k_v * vel_dist ** 2)
    ee_reward = torch.exp(-cfg.k_e * ((cur_ee - exp["ee_wpos"]) ** 2).sum(1))
    com_reward = torch.exp(-cfg.k_c * ((cur_com - exp["com"]) ** 2).sum(1))
    return pose_reward, vel_reward, ee_reward, com_reward


def _vf_reward(topo, cfg, action, explicit: bool):
    """exp(-k_vf · Σ vf²) over the RFC action columns; the explicit
    family sums the force (and torque) parts of each body's slot only,
    not its contact point (reward_function.py:320-328)."""
    ndof, vf_dim, _ = H.action_dims(topo, cfg)
    if not (cfg.residual_force and vf_dim):
        return action.new_zeros(action.shape[0])
    vf = action[:, ndof:ndof + vf_dim]
    if explicit:
        vf = vf.reshape(vf.shape[0], -1, S.body_vf_dim(cfg))[..., 3:]
    return torch.exp(-cfg.k_vf * (vf ** 2).flatten(1).sum(1))


def _weighted(cfg, action, terms):
    ws = action.new_tensor([cfg.w_p, cfg.w_v, cfg.w_e, cfg.w_c, cfg.w_vf])
    return (ws * terms).sum(1) / ws.sum()


def world_rfc_implicit(topo, model, cfg, state, action, expert_lib, aux):
    terms = torch.stack([*_terms(topo, model, cfg, state, expert_lib, aux,
                                 False),
                         _vf_reward(topo, cfg, action, False)], 1)
    return _weighted(cfg, action, terms), terms


def world_rfc_explicit(topo, model, cfg, state, action, expert_lib, aux):
    terms = torch.stack([*_terms(topo, model, cfg, state, expert_lib, aux,
                                 True),
                         _vf_reward(topo, cfg, action, True)], 1)
    return _weighted(cfg, action, terms), terms


def world_rfc_explicit_mul(topo, model, cfg, state, action, expert_lib,
                           aux):
    """The multiplicative version: the product of the five terms."""
    terms = torch.stack([*_terms(topo, model, cfg, state, expert_lib, aux,
                                 True),
                         _vf_reward(topo, cfg, action, True)], 1)
    return terms.prod(1), terms


reward_func = {
    "world_rfc_implicit": world_rfc_implicit,
    "world_rfc_implicit_quat": world_rfc_implicit,
    "quat": world_rfc_implicit,
    "world_rfc_explicit": world_rfc_explicit,
    "world_rfc_explicit_mul": world_rfc_explicit_mul,
}


def get_reward_fn(reward_id: str):
    if reward_id not in reward_func:
        raise NotImplementedError(f"reward {reward_id!r} is not ported yet")
    return reward_func[reward_id]
