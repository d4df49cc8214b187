"""Kinematic-policy (UHM) rewards, batched over envs (PyTorch twin of
uhc_tpu.rewards.uhm_rewards, reference uhc/losses/uhm_rewards.py).

dynamic_supervision_v1 … v6 score the simulated body against (a) the kin
policy's own integrated target (state.target_qpos), (b) the GT context
motion and (c) the GT head pose. Every function is
    fn(topo, model, kin_cfg, cc_cfg, state, context_lib) -> (reward (B,),
                                                             terms (B, n))
at the post-step KinEnvState, with the JAX package's terms in its order.
v2 is dead code in the reference and an alias of v3, as in JAX.
"""
from __future__ import annotations

from typing import Dict

import torch

from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.envs.expert import qpos_fk_frame
from uhc_tpu_torch.envs.humanoid_kin import context_at, head_pose_of
from uhc_tpu_torch.maths import angvel_fd, multi_quat_diff, multi_quat_norm_v2
from uhc_tpu_torch.physics import engine as E
from uhc_tpu_torch.smpl.constants import head_index


def _cur_feats(topo, model, state):
    kin = E.fk(topo, model, state.qpos)
    hi = head_index(topo)
    cur_hpos = torch.cat([kin["xpos"][:, hi], kin["xquat"][:, hi]], 1)
    return H.get_body_quat(state.qpos), kin["xpos"], cur_hpos


def _quat_dist(q1, q0):
    """Mean over joints of ‖q1 ⊗ q0⁻¹ − identity‖ (multi_quat_norm_v2)."""
    return multi_quat_norm_v2(multi_quat_diff(q1, q0)).mean(-1)


def _target_terms(topo, model, kin_cfg, state, cur_bquat, cur_wbpos):
    """p / jp rewards against the policy's own integrated target."""
    k_p, k_jp = kin_cfg.rw("k_p", 1.0), kin_cfg.rw("k_jp", 0.1)
    tgt = qpos_fk_frame(topo, model, state.target_qpos)
    B = cur_wbpos.shape[0]
    pose_quat_diff = _quat_dist(cur_bquat, tgt["bquat"])
    pose_pos_diff = torch.linalg.vector_norm(
        cur_wbpos - tgt["wbpos"].reshape(B, -1, 3), dim=2).mean(1)
    return (torch.exp(-k_p * pose_quat_diff ** 2),
            torch.exp(-k_jp * pose_pos_diff ** 2), tgt)


def _ang_vel_reward(k_act_v, prev_bquat, cur_bquat, gt_prev_q, gt_q, dt):
    cur_bangvel = angvel_fd(prev_bquat, cur_bquat, dt)
    tgt_bangvel = angvel_fd(gt_prev_q, gt_q, dt)
    vel_dist = torch.linalg.vector_norm(cur_bangvel - tgt_bangvel, dim=-1)
    return torch.exp(-k_act_v * vel_dist ** 2)


def dynamic_supervision_v1(topo, model, kin_cfg, cc_cfg, state, context_lib):
    """Additive target-pose + GT-pose + GT-velocity (uhm_rewards.py:8)."""
    w_p, w_jp = kin_cfg.rw("w_p", 1.0), kin_cfg.rw("w_jp", 1.0)
    w_act_p, w_act_v = kin_cfg.rw("w_act_p", 1.0), kin_cfg.rw("w_act_v", 1.0)
    k_act_p, k_act_v = kin_cfg.rw("k_act_p", 0.1), kin_cfg.rw("k_act_v", 0.1)
    cur_bquat, cur_wbpos, _ = _cur_feats(topo, model, state)
    p_reward, jp_reward, _ = _target_terms(topo, model, kin_cfg, state,
                                           cur_bquat, cur_wbpos)
    ind = state.start_ind + state.cur_t
    gt = context_at(context_lib, state.seq_idx, ind)
    gt_prev = context_at(context_lib, state.seq_idx, ind - 1)
    # not squared (reference :49)
    gt_p_reward = torch.exp(-k_act_p * _quat_dist(gt["bquat"], cur_bquat))
    act_v_reward = _ang_vel_reward(k_act_v, state.prev_bquat, cur_bquat,
                                   gt_prev["bquat"], gt["bquat"],
                                   cc_cfg.ctrl_dt)
    reward = (w_p * p_reward + w_jp * jp_reward + w_act_p * gt_p_reward
              + w_act_v * act_v_reward)
    return reward, torch.stack([p_reward, jp_reward, gt_p_reward,
                                act_v_reward], 1)


def _head_terms(topo, model, kin_cfg, state, context_lib, cur_hpos):
    k_hp, k_hq = kin_cfg.rw("k_hp", 1.0), kin_cfg.rw("k_hq", 1.0)
    tgt_hpose = head_pose_of(context_lib, state.seq_idx,
                             state.start_ind + state.cur_t)
    hp_dist = torch.linalg.vector_norm(cur_hpos[:, :3] - tgt_hpose[:, :3],
                                       dim=1)
    hq_dist = _quat_dist(cur_hpos[:, 3:], tgt_hpose[:, 3:])
    return torch.exp(-k_hp * hp_dist ** 2), torch.exp(-k_hq * hq_dist ** 2)


def dynamic_supervision_v3(topo, model, kin_cfg, cc_cfg, state, context_lib):
    """Multiplicative head + target + ARNet-action terms
    (uhm_rewards.py:132)."""
    k_rp, k_rq = kin_cfg.rw("k_rp", 0.1), kin_cfg.rw("k_rq", 0.1)
    k_act_p, k_act_v = kin_cfg.rw("k_act_p", 0.1), kin_cfg.rw("k_act_v", 0.1)
    cur_bquat, cur_wbpos, cur_hpos = _cur_feats(topo, model, state)
    hp_reward, hq_reward = _head_terms(topo, model, kin_cfg, state,
                                       context_lib, cur_hpos)
    p_reward, jp_reward, tgt = _target_terms(topo, model, kin_cfg, state,
                                             cur_bquat, cur_wbpos)
    ind = state.start_ind + state.cur_t
    gt = context_at(context_lib, state.seq_idx, ind)
    gt_prev = context_at(context_lib, state.seq_idx, ind - 1)
    rp_dist = torch.linalg.vector_norm(gt["ar_qpos"][:, :3]
                                       - tgt["qpos"][:, :3], dim=1)
    rq_dist = _quat_dist(gt["ar_qpos"][:, 3:7], tgt["qpos"][:, 3:7])
    pose_action_diff = _quat_dist(gt["ar_bquat"], tgt["bquat"])
    act_v_reward = _ang_vel_reward(k_act_v, state.prev_bquat, cur_bquat,
                                   gt_prev["ar_bquat"], gt["ar_bquat"],
                                   cc_cfg.ctrl_dt)
    rq_reward = torch.exp(-k_rq * rq_dist ** 2)
    rp_reward = torch.exp(-k_rp * rp_dist ** 2)
    act_p_reward = torch.exp(-k_act_p * pose_action_diff)
    reward = (hp_reward * hq_reward * p_reward * jp_reward * rp_reward
              * rq_reward * act_p_reward)
    return reward, torch.stack([hp_reward, hq_reward, p_reward, jp_reward,
                                rp_reward, rq_reward, act_p_reward,
                                act_v_reward], 1)


def _head_target_terms(topo, model, kin_cfg, state, context_lib):
    cur_bquat, cur_wbpos, cur_hpos = _cur_feats(topo, model, state)
    hp, hq = _head_terms(topo, model, kin_cfg, state, context_lib, cur_hpos)
    p, jp, _ = _target_terms(topo, model, kin_cfg, state, cur_bquat,
                             cur_wbpos)
    return hp, hq, p, jp, cur_bquat


def dynamic_supervision_v4(topo, model, kin_cfg, cc_cfg, state, context_lib):
    """Additive head + target terms; the hv term is a constant 0 in the
    reference (uhm_rewards.py:193)."""
    w_hp, w_hq = kin_cfg.rw("w_hp", 1.0), kin_cfg.rw("w_hq", 1.0)
    w_hv = kin_cfg.rw("w_hv", 0.05)
    w_p, w_jp = kin_cfg.rw("w_p", 1.0), kin_cfg.rw("w_jp", 1.0)
    hp, hq, p, jp, _ = _head_target_terms(topo, model, kin_cfg, state,
                                          context_lib)
    hv = torch.zeros_like(hp)
    reward = w_hp * hp + w_hq * hq + w_hv * hv + w_p * p + w_jp * jp
    return reward, torch.stack([hp, hq, hv, p, jp], 1)


def dynamic_supervision_v5(topo, model, kin_cfg, cc_cfg, state, context_lib):
    """Multiplicative head + target terms (uhm_rewards.py:265)."""
    hp, hq, p, jp, _ = _head_target_terms(topo, model, kin_cfg, state,
                                          context_lib)
    return hp * hq * p * jp, torch.stack([hp, hq, torch.zeros_like(hp), p,
                                          jp], 1)


def dynamic_supervision_v6(topo, model, kin_cfg, cc_cfg, state, context_lib):
    """Additive head + target + ARNet angular-velocity terms
    (uhm_rewards.py:311)."""
    w_hp, w_hq = kin_cfg.rw("w_hp", 1.0), kin_cfg.rw("w_hq", 1.0)
    w_p, w_jp = kin_cfg.rw("w_p", 1.0), kin_cfg.rw("w_jp", 1.0)
    w_act_v, k_act_v = kin_cfg.rw("w_act_v", 1.0), kin_cfg.rw("k_act_v", 0.1)
    hp, hq, p, jp, cur_bquat = _head_target_terms(topo, model, kin_cfg,
                                                  state, context_lib)
    ind = state.start_ind + state.cur_t
    gt = context_at(context_lib, state.seq_idx, ind)
    gt_prev = context_at(context_lib, state.seq_idx, ind - 1)
    act_v = _ang_vel_reward(k_act_v, state.prev_bquat, cur_bquat,
                            gt_prev["ar_bquat"], gt["ar_bquat"],
                            cc_cfg.ctrl_dt)
    reward = w_hp * hp + w_hq * hq + w_p * p + w_jp * jp + w_act_v * act_v
    return reward, torch.stack([hp, hq, p, jp, act_v], 1)


def constant_reward(topo, model, kin_cfg, cc_cfg, state, context_lib):
    """uhm_rewards.py:380."""
    B = state.qpos.shape[0]
    return state.qpos.new_ones(B), state.qpos.new_zeros((B, 1))


def forward_v1(topo, model, kin_cfg, cc_cfg, state, context_lib):
    """Locomotion-to-a-point test reward (uhm_rewards.py:386)."""
    k_rp = kin_cfg.rw("k_rp", 1.0)
    target_pos = state.qpos.new_tensor([10.0, 10.0, 0.9])
    rp_dist = torch.linalg.vector_norm(state.qpos[:, :3] - target_pos, dim=1)
    rp_reward = torch.exp(-k_rp * rp_dist ** 2)
    return rp_reward, rp_reward[:, None]


uhm_reward_func: Dict[str, callable] = {
    "dynamic_supervision_v1": dynamic_supervision_v1,
    "dynamic_supervision_v2": dynamic_supervision_v3,  # dead code in ref
    "dynamic_supervision_v3": dynamic_supervision_v3,
    "dynamic_supervision_v4": dynamic_supervision_v4,
    "dynamic_supervision_v5": dynamic_supervision_v5,
    "dynamic_supervision_v6": dynamic_supervision_v6,
    "constant": constant_reward,
    "forward_v1": forward_v1,
}


def get_uhm_reward_fn(reward_id: str):
    return uhm_reward_func[reward_id]
