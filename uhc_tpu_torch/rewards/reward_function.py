"""Imitation reward (PyTorch twin of uhc_tpu.rewards.reward_function),
batched: every id of its registry.

reward_fn(topo, model, cfg, state, action, expert_lib, aux) ->
    ((B,) reward, (B, n) per-term tensor)
evaluated at the post-step state against the expert frame
start_ind + cur_t. n is 5 for the world_rfc_implicit / _explicit
families, 6 for local_rfc_implicit and world_rfc_implicit_v2 / _v3, 7 for
local_rfc_explicit.
"""
from __future__ import annotations

import torch

from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.maths import (angvel_fd, de_heading, multi_quat_diff,
                                 multi_quat_norm, qvel_fd, transform_vec)
from uhc_tpu_torch.physics import engine as E
from uhc_tpu_torch.physics import solver as S
from uhc_tpu_torch.smpl.constants import ee_indices
from uhc_tpu_torch.utils.consts import const


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
    cur_ee = kin["xpos"][:, _ee(topo, state.qpos)].reshape(B, -1)
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
    ws = const((cfg.w_p, cfg.w_v, cfg.w_e, cfg.w_c, cfg.w_vf), action)
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


def world_rfc_implicit_v1_mul(topo, model, cfg, state, action, expert_lib,
                              aux):
    """The multiplicative world_rfc_implicit (reward_function.py:90); the
    RFC term multiplies in only where w_vf is nonzero."""
    terms = torch.stack([*_terms(topo, model, cfg, state, expert_lib, aux,
                                 False),
                         _vf_reward(topo, cfg, action, False)], 1)
    return (terms[:, :4].prod(1) if cfg.w_vf == 0.0 else terms.prod(1),
            terms)


def _ee(topo, like):
    """The end-effector bodies' rows, on `like`'s device."""
    return const(tuple(int(i) for i in ee_indices(topo)), like, torch.int64)


def _local_terms(topo, model, cfg, state, expert_lib, aux):
    """The root-relative terms of the local_rfc family
    (uhc_tpu/rewards/reward_function.py:156-209): joint pose without the root, joint
    angular velocity, end effectors in the root frame, root height and
    de-headed rotation, root velocity from finite differences across the
    control step (its linear part in the previous root's frame)."""
    exp = H.expert_at(expert_lib, state.seq_idx,
                      state.start_ind + state.cur_t)
    kin = E.fk(topo, model, state.qpos)
    B = state.qpos.shape[0]
    dt, c = cfg.ctrl_dt, cfg.obs_coord
    k_p, k_v, k_e = cfg.rw("k_p", 2.0), cfg.rw("k_v", 0.005), \
        cfg.rw("k_e", 20.0)
    k_rh, k_rq = cfg.rw("k_rh", 300.0), cfg.rw("k_rq", 300.0)
    k_rl, k_ra = cfg.rw("k_rl", 5.0), cfg.rw("k_ra", 0.5)

    qpos, prev = state.qpos, state.prev_qpos
    cur_qvel = qvel_fd(prev, qpos, dt)
    cur_rlinv_local = transform_vec(cur_qvel[:, :3], prev[:, 3:7], c)
    cur_ee = transform_vec(
        kin["xpos"][:, _ee(topo, qpos)] - qpos[:, None, :3],
        qpos[:, None, 3:7], c).reshape(B, -1)
    cur_bquat = H.get_body_quat(qpos)
    cur_bangvel = angvel_fd(state.prev_bquat, cur_bquat, dt)

    pose_diff = multi_quat_norm(multi_quat_diff(
        cur_bquat[:, 4:], exp["bquat"][:, 4:])) * aux["body_diffw"]
    pose_reward = torch.exp(-k_p * (pose_diff ** 2).sum(1))
    vel_dist = torch.linalg.vector_norm(
        cur_bangvel[:, 3:] - exp["bangvel"][:, 3:], dim=1)
    vel_reward = torch.exp(-k_v * vel_dist ** 2)
    ee_reward = torch.exp(-k_e * ((cur_ee - exp["ee_pos"]) ** 2).sum(1))
    root_height_dist = qpos[:, 2] - exp["qpos"][:, 2]
    root_quat_dist = multi_quat_norm(multi_quat_diff(
        de_heading(qpos[:, 3:7]), de_heading(exp["qpos"][:, 3:7])))[:, 0]
    root_pose_reward = torch.exp(-k_rh * root_height_dist ** 2
                                 - k_rq * root_quat_dist ** 2)
    root_linv_dist = torch.linalg.vector_norm(
        cur_rlinv_local - exp["rlinv_local"], dim=1)
    root_angv_dist = torch.linalg.vector_norm(
        cur_qvel[:, 3:6] - exp["rangv"], dim=1)
    root_vel_reward = torch.exp(-k_rl * root_linv_dist ** 2
                                - k_ra * root_angv_dist ** 2)
    return (pose_reward, vel_reward, ee_reward, root_pose_reward,
            root_vel_reward)


def _normalized(ws, terms):
    ws = const(tuple(ws), terms)
    return (ws * terms).sum(1) / ws.sum()


def local_rfc_implicit(topo, model, cfg, state, action, expert_lib, aux):
    """reward_function.py:212 (local_rfc_implicit): the local
    terms and, where w_vf > 0, the RFC magnitude term."""
    local = _local_terms(topo, model, cfg, state, expert_lib, aux)
    w_vf = cfg.rw("w_vf", 0.1)
    ndof, vf_dim, _ = H.action_dims(topo, cfg)
    if w_vf > 0.0 and vf_dim:
        vf_reward = torch.exp(-cfg.rw("k_vf", 1.0) * (
            action[:, ndof:ndof + vf_dim] ** 2).sum(1))
    else:
        vf_reward = action.new_zeros(action.shape[0])
    terms = torch.stack([*local, vf_reward], 1)
    return _normalized([cfg.rw("w_p", 0.5), cfg.rw("w_v", 0.0),
                        cfg.rw("w_e", 0.2), cfg.rw("w_rp", 0.1),
                        cfg.rw("w_rv", 0.1), w_vf], terms), terms


def local_rfc_explicit(topo, model, cfg, state, action, expert_lib, aux):
    """reward_function.py:230 (local_rfc_explicit): the local terms
    and each body's residual force split into its force / torque part and
    its contact point, penalized apart."""
    local = _local_terms(topo, model, cfg, state, expert_lib, aux)
    ndof, vf_dim, _ = H.action_dims(topo, cfg)
    if vf_dim:
        vf = action[:, ndof:ndof + vf_dim].reshape(
            action.shape[0], -1, S.body_vf_dim(cfg))
        vf_reward = torch.exp(-cfg.rw("k_vf", 20.0)
                              * (vf[..., 3:] ** 2).flatten(1).sum(1))
        cp_reward = torch.exp(-cfg.rw("k_cp", 10.0)
                              * (vf[..., :3] ** 2).flatten(1).sum(1))
    else:
        vf_reward = cp_reward = action.new_ones(action.shape[0])
    terms = torch.stack([*local, vf_reward, cp_reward], 1)
    return _normalized([cfg.rw("w_p", 0.4), cfg.rw("w_v", 0.0),
                        cfg.rw("w_e", 0.2), cfg.rw("w_rp", 0.1),
                        cfg.rw("w_rv", 0.1), cfg.rw("w_vf", 0.1),
                        cfg.rw("w_cp", 0.1)], terms), terms


def _v2_terms(topo, model, cfg, state, action, expert_lib):
    """The mean-squared world-frame terms of v2 / v3
    (reward_function.py:252-296), weighted per body by the reward
    weights' jpos_diffw (ones without it): pose, world pose, COM, joint
    positions, angular velocity, RFC magnitude -> (B, 6)."""
    exp = H.expert_at(expert_lib, state.seq_idx,
                      state.start_ind + state.cur_t)
    kin = E.fk(topo, model, state.qpos)
    B = state.qpos.shape[0]
    jw = cfg.rw("jpos_diffw", None)
    jw = (const(tuple(jw), state.qpos) if jw is not None
          else state.qpos.new_ones(topo.nbody))
    cur_bquat = H.get_body_quat(state.qpos)
    cur_bangvel = angvel_fd(state.prev_bquat, cur_bquat, cfg.ctrl_dt)

    pose_diff = multi_quat_norm(multi_quat_diff(cur_bquat,
                                                exp["bquat"])) * jw
    wpose_diff = multi_quat_norm(multi_quat_diff(
        kin["xquat"].reshape(B, -1), exp["wbquat"])) * jw
    com_diff = (exp["body_com"].reshape(B, -1, 3) - kin["xipos"]) \
        * jw[:, None]
    jpos_diff = (kin["xpos"] - exp["wbpos"].reshape(B, -1, 3)) \
        * jw[:, None]
    ndof, vf_dim, _ = H.action_dims(topo, cfg)
    vf_reward = (torch.exp(-cfg.rw("k_vf", 1.0) * (
        action[:, ndof:ndof + vf_dim] ** 2).sum(1)) if vf_dim
        else action.new_ones(B))
    return torch.stack([
        torch.exp(-cfg.rw("k_p", 0.4) * (pose_diff ** 2).mean(1)),
        torch.exp(-cfg.rw("k_wp", 0.4) * (wpose_diff ** 2).mean(1)),
        torch.exp(-cfg.rw("k_c", 100.0) * (com_diff ** 2).sum(2).mean(1)),
        torch.exp(-cfg.rw("k_j", 100.0) * (jpos_diff ** 2).sum(2).mean(1)),
        torch.exp(-cfg.rw("k_v", 0.005)
                  * ((cur_bangvel - exp["bangvel"]) ** 2).mean(1)),
        vf_reward], 1)


def world_rfc_implicit_v2(topo, model, cfg, state, action, expert_lib, aux):
    """reward_function.py:299: the product of the six v2 terms."""
    terms = _v2_terms(topo, model, cfg, state, action, expert_lib)
    return terms.prod(1), terms


def world_rfc_implicit_v3(topo, model, cfg, state, action, expert_lib, aux):
    """reward_function.py:307: their weighted sum, not divided by the
    weights' sum (as in the reference)."""
    terms = _v2_terms(topo, model, cfg, state, action, expert_lib)
    ws = const((cfg.rw("w_p", 0.4), cfg.rw("w_wp", 0.4),
                cfg.rw("w_c", 100.0), cfg.rw("w_j", 100.0),
                cfg.rw("w_v", 0.005), cfg.rw("w_vf", 1.0)), terms)
    return (ws * terms).sum(1), terms


reward_func = {
    "world_rfc_implicit": world_rfc_implicit,
    "world_rfc_implicit_quat": world_rfc_implicit,
    "quat": world_rfc_implicit,
    "world_rfc_implicit_v1_mul": world_rfc_implicit_v1_mul,
    "world_rfc_explicit": world_rfc_explicit,
    "world_rfc_explicit_mul": world_rfc_explicit_mul,
    "local_rfc_implicit": local_rfc_implicit,
    "local_rfc_explicit": local_rfc_explicit,
    "world_rfc_implicit_v2": world_rfc_implicit_v2,
    "world_rfc_implicit_v3": world_rfc_implicit_v3,
}


def get_reward_fn(reward_id: str):
    return reward_func[reward_id]
