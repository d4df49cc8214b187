"""Copycat (motion imitation) environment, batched over envs (PyTorch twin
of uhc_tpu.envs.humanoid_im).

The env is a set of functions over an `EnvState` of (B, ...) tensors and a
device-resident expert library. One 30 Hz control step is frame_skip
stable-PD substeps at 450 Hz; `make_env_step_batched` routes them through
a hand-written CUDA control-step kernel (K1 `physics.control_step`, or K2
`physics.control_step_split` under UHC_TPU_LANE=0; K1f for explicit RFC
and per-joint meta-PD; K1d on the 48-body masterfoot and 52-body SMPL-H
trees; K2 on the 55-body SMPL-X) when given the model to bake, else
through the plain PCG chain.
Obs, reward and termination read the tree's sizes from its topology.

The model is shared, or a per-sequence library (shape-conditioned or
domain-randomized training, `data.dataset.build_shaped_library` /
`build_dr_library`): each env then simulates, observes and is rewarded
on its own sequence's model, gathered by its seq_idx (`env_models`), and
the kernels take the library with seq_idx (K1e).

Ported: obs v0 to v6 (v1, v2, v4 to v6 with the shape observation) and
the ball family's v2_quat, every reward family of
`rewards.reward_function`, implicit and explicit RFC, plain, meta-PD and
per-joint meta-PD, direct torque control (action_type "torque", the ball
family's; no kernel, as in the JAX package), body-diff termination, and
scene objects: the library's obj_pose track played back by every step
(the batched step keeps its kernel), or dynamic bodies on the exact
chain (`env_step(obj_model=)`, `physics.objects`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

from uhc_tpu_torch.config.config import EnvConfig
from uhc_tpu_torch.maths import (de_heading, de_heading_new, heading_angle,
                                 heading_angle_new, heading_quat,
                                 heading_quat_new, quat_from_euler_zyx,
                                 quat_inv, quat_mul, transform_vec,
                                 wrap_to_pi)
from uhc_tpu_torch.physics import engine as E
from uhc_tpu_torch.physics import solver as S
from uhc_tpu_torch.physics.model import (Model, Topology, env_models,
                                         model_batch_axes, model_is_batched,
                                         model_per_env)
from uhc_tpu_torch.smpl.constants import head_index
from uhc_tpu_torch.utils.spans import count, span


@dataclasses.dataclass
class EnvState:
    qpos: Any          # (B, nq)
    qvel: Any          # (B, nv)
    prev_qpos: Any     # (B, nq)
    cur_t: Any         # (B,) int64
    start_ind: Any     # (B,) int64
    seq_idx: Any       # (B,) int64
    prev_bquat: Any    # (B, nb*4)
    done: Any          # (B,) bool
    fail: Any          # (B,) bool
    end: Any           # (B,) bool
    percent: Any       # (B,) float
    # scene objects (the library's obj_pose track, dataset_smpl_obj.py):
    # (B, 7·NO) free-joint poses, kinematic playback of the clip, or
    # dynamic bodies stepped by do_simulation when env_step gets an
    # obj_model (then obj_qvel (B, 6·NO)); None without a track
    obj_qpos: Any = None
    obj_qvel: Any = None


def state_where(mask, new, old):
    """Per-env select between two states of one dataclass (EnvState, or
    the kin env's KinEnvState): `new` where the (B,) mask is true. A field
    that is None in both stays None, as a pytree's None leaf does in the
    JAX package."""
    out = {}
    for f in dataclasses.fields(new):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if a is None and b is None:
            out[f.name] = None
            continue
        m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
        out[f.name] = torch.where(m, a, b)
    return type(new)(**out)


PER_SEQ_KEYS = ("len", "height_lb", "head_height_lb", "beta", "gender",
                "shape_obs", "weight")

# The control-step kernels' trees, as the JAX package routes them
# (uhc_tpu/envs/humanoid_im.py:873-880,921-957): every tree of up to 32
# bodies on the lane kernel's small-tree path (the 24-body SMPL humanoid,
# remove_toe's 22 bodies), 33 to 52 bodies on its big-tree path
# (masterfoot, SMPL-H), and more than 52 (SMPL-X) on the head/tail kernel
# only.
LANE_SMALL_MAX, LANE_BIG_MAX = 32, 52



def expert_at(expert_lib: Dict[str, Any], seq_idx, t) -> dict:
    """Expert features of sequences `seq_idx` (B,) at frames
    min(t, len-1) (B,)."""
    length = expert_lib["len"][seq_idx]
    ind = torch.minimum(t, length - 1)
    out = {k: v[seq_idx, ind] for k, v in expert_lib.items()
           if k not in PER_SEQ_KEYS}
    out["len"] = length
    return out


def action_dims(topo: Topology, cfg: EnvConfig):
    """(ndof, vf_dim, meta_dim) of the action vector."""
    S.check_supported(cfg)
    return S.action_dims(topo, cfg)


def do_simulation(topo: Topology, model: Model, cfg: EnvConfig, qpos, qvel,
                  action, target_base, rfc_rate, obj=None):
    """One control step with an exact factorization at every substep
    (`engine.substep`, the reference path; `make_env_step_batched` uses
    the PCG chain). `model` is shared or per env. Torque control is
    `solver.torque_substeps`, exact on either path.

    `obj` = (ObjModel, obj_qpos (B, 7·NO), obj_qvel (B, 6·NO)) steps
    dynamic scene objects with the body (uhc_tpu/envs/humanoid_im.py:
    121-221); the step then returns (qpos, qvel, obj_qpos, obj_qvel).
    Under torque control the objects are returned as they came, as the
    JAX package's torque substep leaves them."""
    S.check_supported(cfg)
    if cfg.action_type == "torque":
        qpos, qvel = S.torque_substeps(topo, cfg, model, qpos, qvel, action,
                                       rfc_rate)
        return (qpos, qvel) if obj is None else (qpos, qvel, obj[1], obj[2])
    B = qpos.shape[0]
    model = model_per_env(model, B)
    ndof, vf_dim, _ = S.action_dims(topo, cfg)
    kp_scale, kd_scale = S.gain_scales(cfg, action, ndof, vf_dim)
    vf_body = S.explicit_wrench(topo, cfg, model, action, ndof, vf_dim)
    if obj is not None:
        om, obj_qpos, obj_qvel = obj
        qp_shape, qv_shape = obj_qpos.shape, obj_qvel.shape
        obj_qpos, obj_qvel = obj_qpos.reshape(B, -1, 7), obj_qvel.reshape(
            B, -1, 6)
    for i in range(cfg.frame_skip):
        if cfg.action_v == 1:
            base = qpos[:, 7:] + wrap_to_pi(target_base - qpos[:, 7:])
        else:
            base = torch.zeros_like(qpos[:, 7:])
        target_pos = base + action[:, :ndof]
        qfrc = S.implicit_rfc(cfg, qpos, action, ndof, rfc_rate)
        kp = model.jkp * kp_scale[:, i]
        kd = model.jkd * kd_scale[:, i]
        out = E.substep(topo, model, qpos, qvel, target_pos, kp, kd, qfrc,
                        cfg.self_collision, vf_body, S.vf_gate_mode(cfg),
                        None if obj is None else (om, obj_qpos, obj_qvel))
        qpos, qvel = out[0], out[1]
        if obj is not None:
            obj_qpos, obj_qvel = out[3]
    if obj is None:
        return qpos, qvel
    return (qpos, qvel, obj_qpos.reshape(qp_shape),
            obj_qvel.reshape(qv_shape))


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------


def get_body_quat(qpos: torch.Tensor) -> torch.Tensor:
    """Root quat + per-joint local quats, flat (B, nb*4). A ball-joint
    qpos (7 + 4·nj wide, never 7 mod 3 on the trees ported) holds them
    already."""
    B = qpos.shape[0]
    if (qpos.shape[1] - 7) % 3:
        return qpos[:, 3:]
    jq = quat_from_euler_zyx(qpos[:, 7:].reshape(B, -1, 3))
    return torch.cat([qpos[:, None, 3:7], jq], 1).reshape(B, -1)


def obs_v12(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
            expert_lib, shape_obs=None, tgt=None,
            delta_t: int = 0) -> torch.Tensor:
    """get_full_obs_v1 (cfg.obs_v 1) and _v2 (obs_v 2: v1 without the COM
    blocks; uhc_tpu/envs/humanoid_im.py:247-310), feature-order exact: the
    reference's double linear-velocity transform, its target_root_quat[:3]
    read as rel_pos, and component-major position blocks. `model` is
    shared or per env. The target is the expert `delta_t` frames past the
    next one."""
    qpos, qvel = state.qpos, state.qvel
    B = qpos.shape[0]
    # a tensor copied from the host: on a card the copy waits for the
    # stream (utils/spans.py counts it)
    count("host_sync")
    base_rot = qpos.new_tensor(cfg.base_rot)
    if tgt is None:
        tgt = expert_at(expert_lib, state.seq_idx,
                        state.start_ind + state.cur_t + 1 + delta_t)
    kin = E.fk(topo, model, qpos)
    c = cfg.obs_coord
    obs = []
    qvel = torch.cat([transform_vec(qvel[:, :3], qpos[:, 3:7], c),
                      qvel[:, 3:]], 1)
    curr_root_quat = quat_mul(qpos[:, 3:7], quat_inv(base_rot))
    hq = heading_quat(curr_root_quat)
    obs.append(hq)

    target_qpos = tgt["qpos"]
    target_quat = tgt["wbquat"].reshape(B, -1, 4)
    target_jpos = tgt["wbpos"].reshape(B, -1, 3)
    target_root_quat = quat_mul(target_qpos[:, 3:7], quat_inv(base_rot))

    qpos_dh = torch.cat([qpos[:, :3], de_heading(curr_root_quat),
                         qpos[:, 7:]], 1)
    diff_qpos = _diff_qpos(target_qpos, qpos_dh, target_root_quat,
                           curr_root_quat)
    obs += [target_qpos[:, 2:], qpos_dh[:, 2:], diff_qpos[:, 2:]]

    qvel = torch.cat([transform_vec(qvel[:, :3], curr_root_quat, c),
                      qvel[:, 3:]], 1)
    obs.append(qvel if cfg.obs_vel == "full" else qvel[:, :6])
    rel_h = wrap_to_pi(heading_angle(target_root_quat)
                       - heading_angle(curr_root_quat))
    obs.append(rel_h[:, None])
    rel_pos = transform_vec(target_root_quat[:, :3] - qpos_dh[:, :3],
                            curr_root_quat, c)
    obs.append(rel_pos[:, :2])

    crq = curr_root_quat[:, None]
    curr_jpos = kin["xpos"]
    blocks = [curr_jpos - qpos_dh[:, None, :3], target_jpos - curr_jpos]
    if cfg.obs_v == 1:
        target_com = tgt["body_com"].reshape(B, -1, 3)
        blocks += [kin["xipos"] - qpos_dh[:, None, :3],
                   target_com - kin["xipos"]]
    for v in blocks:
        obs.append(_component_major(transform_vec(v, crq, c)))
    cur_quat = kin["xquat"]
    obs.append(quat_mul(quat_inv(hq)[:, None], cur_quat).reshape(B, -1))
    obs.append(quat_mul(quat_inv(cur_quat), target_quat).reshape(B, -1))
    if cfg.has_shape and cfg.has_shape_obs and shape_obs is not None:
        obs.append(shape_obs)
    return torch.cat(obs, 1)


def _diff_qpos(target_qpos, qpos_dh, target_root_quat, curr_root_quat):
    """target qpos less the de-headed qpos (height and joints), the root
    rotation between the two, target xy kept."""
    return torch.cat([
        target_qpos[:, :2], target_qpos[:, 2:3] - qpos_dh[:, 2:3],
        quat_mul(target_root_quat, quat_inv(curr_root_quat)),
        target_qpos[:, 7:] - qpos_dh[:, 7:]], 1)


def _component_major(v: torch.Tensor) -> torch.Tensor:
    """(B, n, 3) -> (B, 3n), x of every row first: the reference's
    transform_vec_batch returns (3, n) and ravels it."""
    return v.transpose(1, 2).reshape(v.shape[0], -1)


def obs_v0(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
           expert_lib, tgt=None) -> torch.Tensor:
    """get_full_obs (uhc_tpu/envs/humanoid_im.py:455-478): [heading?]
    qpos[2:] (de-headed with root_deheading), qvel, the expert's joint
    pose at the current frame, [phase?]."""
    qpos, qvel = state.qpos, state.qvel
    if tgt is None:
        tgt = expert_at(expert_lib, state.seq_idx,
                        state.start_ind + state.cur_t)
    qvel = torch.cat([transform_vec(qvel[:, :3], qpos[:, 3:7],
                                    cfg.obs_coord), qvel[:, 3:]], 1)
    obs = []
    if cfg.obs_heading:
        obs.append(heading_angle(qpos[:, 3:7])[:, None])
    if cfg.root_deheading:
        qpos = torch.cat([qpos[:, :3], de_heading(qpos[:, 3:7]),
                          qpos[:, 7:]], 1)
    obs.append(qpos[:, 2:])
    obs.append(qvel if cfg.obs_vel == "full" else qvel[:, :6])
    obs.append(tgt["qpos"][:, 7:])
    if cfg.obs_phase:
        obs.append((state.cur_t.to(qpos.dtype)
                    / tgt["len"].to(qpos.dtype))[:, None])
    return torch.cat(obs, 1)


def obs_v4(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
           expert_lib, shape_obs=None, tgt=None) -> torch.Tensor:
    """get_full_obs_v4 (uhc_tpu/envs/humanoid_im.py:549-604): a global
    block then the (nb-1, 26) local rows of the non-root bodies, flat:
    [target pose | cur pose | diff pose | joint qvel | r_jpos | diff_jpos
    | heading-relative quat | relative quat] (the transformer actor's
    tokens)."""
    qpos, qvel = state.qpos, state.qvel
    B = qpos.shape[0]
    count("host_sync")
    base_rot = qpos.new_tensor(cfg.base_rot)
    if tgt is None:
        tgt = expert_at(expert_lib, state.seq_idx,
                        state.start_ind + state.cur_t + 1)
    kin = E.fk(topo, model, qpos)
    c = cfg.obs_coord
    qvel = torch.cat([transform_vec(qvel[:, :3], qpos[:, 3:7], c),
                      qvel[:, 3:]], 1)
    curr_root_quat = quat_mul(qpos[:, 3:7], quat_inv(base_rot))
    hq = heading_quat(curr_root_quat)
    target_qpos = tgt["qpos"]
    target_quat = tgt["wbquat"].reshape(B, -1, 4)
    target_jpos = tgt["wbpos"].reshape(B, -1, 3)
    target_root_quat = quat_mul(target_qpos[:, 3:7], quat_inv(base_rot))
    qpos_dh = torch.cat([qpos[:, :3], de_heading(curr_root_quat),
                         qpos[:, 7:]], 1)
    diff_qpos = _diff_qpos(target_qpos, qpos_dh, target_root_quat,
                           curr_root_quat)

    def rows(x):
        return x[:, 7:].reshape(B, -1, 3)

    g = [hq, target_qpos[:, 2:7], qpos_dh[:, 2:7], diff_qpos[:, 2:7]]
    loc = [rows(target_qpos), rows(qpos_dh), rows(diff_qpos)]
    qvel = torch.cat([transform_vec(qvel[:, :3], curr_root_quat, c),
                      qvel[:, 3:]], 1)
    g.append(qvel[:, :6])
    if cfg.obs_vel != "root":
        loc.append(qvel[:, 6:].reshape(B, -1, 3))
    g.append(wrap_to_pi(heading_angle(target_root_quat)
                        - heading_angle(curr_root_quat))[:, None])
    # v4 reads the target's qpos[:3] here (the reference's corrected
    # rel_pos)
    g.append(transform_vec(target_qpos[:, :3] - qpos_dh[:, :3],
                           curr_root_quat, c)[:, :2])
    crq = curr_root_quat[:, None]
    curr_jpos = kin["xpos"]
    loc.append(transform_vec(curr_jpos - qpos_dh[:, None, :3], crq,
                             c)[:, 1:])
    loc.append(transform_vec(target_jpos - curr_jpos, crq, c)[:, 1:])
    cur_quat = kin["xquat"]
    loc.append(quat_mul(quat_inv(hq)[:, None], cur_quat)[:, 1:])
    loc.append(quat_mul(quat_inv(cur_quat), target_quat)[:, 1:])
    if cfg.has_shape and shape_obs is not None:
        g.append(shape_obs)
    return torch.cat(g + [torch.cat(loc, 2).reshape(B, -1)], 1)


def obs_v5(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
           expert_lib, shape_obs=None, tgt=None) -> torch.Tensor:
    """get_full_obs_v5 (uhc_tpu/envs/humanoid_im.py:605-652), v2 with the
    atan2 heading: no heading quaternion block, one linear-velocity
    transform, the target's qpos[:3] in rel_pos."""
    qpos, qvel = state.qpos, state.qvel
    B = qpos.shape[0]
    count("host_sync")
    base_rot = qpos.new_tensor(cfg.base_rot)
    if tgt is None:
        tgt = expert_at(expert_lib, state.seq_idx,
                        state.start_ind + state.cur_t + 1)
    kin = E.fk(topo, model, qpos)
    c = cfg.obs_coord
    target_qpos = tgt["qpos"]
    target_quat = tgt["wbquat"].reshape(B, -1, 4)
    target_jpos = tgt["wbpos"].reshape(B, -1, 3)
    curr_root_quat = quat_mul(qpos[:, 3:7], quat_inv(base_rot))
    target_root_quat = quat_mul(target_qpos[:, 3:7], quat_inv(base_rot))
    hq = heading_quat_new(curr_root_quat)
    qpos_dh = torch.cat([qpos[:, :3], de_heading_new(curr_root_quat),
                         qpos[:, 7:]], 1)
    diff_qpos = _diff_qpos(target_qpos, qpos_dh, target_root_quat,
                           curr_root_quat)
    obs = [target_qpos[:, 2:], qpos_dh[:, 2:], diff_qpos[:, 2:]]
    qvel = torch.cat([transform_vec(qvel[:, :3], curr_root_quat, c),
                      qvel[:, 3:]], 1)
    obs.append(qvel if cfg.obs_vel == "full" else qvel[:, :6])
    obs.append(wrap_to_pi(heading_angle_new(target_root_quat)
                          - heading_angle_new(curr_root_quat))[:, None])
    obs.append(transform_vec(target_qpos[:, :3] - qpos_dh[:, :3],
                             curr_root_quat, c)[:, :2])
    crq = curr_root_quat[:, None]
    curr_jpos = kin["xpos"]
    for v in (curr_jpos - qpos_dh[:, None, :3], target_jpos - curr_jpos):
        obs.append(_component_major(transform_vec(v, crq, c)))
    cur_quat = kin["xquat"]
    obs.append(quat_mul(quat_inv(hq)[:, None], cur_quat).reshape(B, -1))
    obs.append(quat_mul(quat_inv(cur_quat), target_quat).reshape(B, -1))
    if cfg.has_shape and cfg.has_shape_obs and shape_obs is not None:
        obs.append(shape_obs)
    return torch.cat(obs, 1)


def obs_v6(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
           expert_lib, shape_obs=None, tgt=None) -> torch.Tensor:
    """get_full_obs_v6 (uhc_tpu/envs/humanoid_im.py:653-694): the root's
    relative position, heading and rotation, qvel, heading-frame joint
    positions and local joint quaternions. The reference drops a
    component row of the (3, nb) joint-position block, not the root body
    (2·nb features): kept."""
    qpos, qvel = state.qpos, state.qvel
    B = qpos.shape[0]
    count("host_sync")
    base_rot = qpos.new_tensor(cfg.base_rot)
    if tgt is None:
        tgt = expert_at(expert_lib, state.seq_idx,
                        state.start_ind + state.cur_t + 1)
    kin = E.fk(topo, model, qpos)
    curr_root_quat = quat_mul(qpos[:, 3:7], quat_inv(base_rot))
    hq = heading_quat_new(curr_root_quat)
    target_qpos = tgt["qpos"]
    target_jpos = tgt["wbpos"].reshape(B, -1, 3)
    target_root_quat = quat_mul(target_qpos[:, 3:7], quat_inv(base_rot))
    obs = [transform_vec(target_qpos[:, :3] - qpos[:, :3], hq),
           wrap_to_pi(heading_angle_new(target_root_quat)
                      - heading_angle_new(curr_root_quat))[:, None],
           quat_mul(target_root_quat, quat_inv(curr_root_quat))]
    qvel = torch.cat([transform_vec(qvel[:, :3], hq), qvel[:, 3:]], 1)
    obs.append(qvel if cfg.obs_vel == "full" else qvel[:, :6])
    curr_jpos = kin["xpos"]
    r_jpos = transform_vec(curr_jpos - qpos[:, None, :3], hq[:, None])
    obs.append(r_jpos.transpose(1, 2)[:, 1:].reshape(B, -1))
    obs.append(_component_major(transform_vec(
        (target_jpos - curr_jpos)[:, 1:], hq[:, None])))
    target_bquat = tgt["bquat"].reshape(B, -1, 4)[:, 1:]
    cur_bquat = get_body_quat(qpos).reshape(B, -1, 4)[:, 1:]
    obs.append(cur_bquat.reshape(B, -1))
    obs.append(quat_mul(quat_inv(cur_bquat), target_bquat).reshape(B, -1))
    if cfg.has_shape and cfg.has_shape_obs and shape_obs is not None:
        obs.append(shape_obs)
    return torch.cat(obs, 1)


def obs_v2_quat(topo: Topology, model: Model, cfg: EnvConfig,
                state: EnvState, expert_lib, shape_obs=None,
                tgt=None) -> torch.Tensor:
    """get_full_obs_v2_quat (uhc_tpu/envs/humanoid_im.py:313-377), the ball
    family's obs v2, feature-order exact: heading quat, the target's, the
    current and their difference's root height, q_cur⁻¹ ⊗ q_target over
    the base-removed root and every joint quaternion, qvel (linear part
    transformed twice, as the reference), relative heading, the target
    root quat's xyz as rel_pos (the reference's read), component-major
    joint-position blocks, heading-relative and relative body quats."""
    qpos, qvel = state.qpos, state.qvel
    B = qpos.shape[0]
    count("host_sync")
    base_rot = qpos.new_tensor(cfg.base_rot)
    if tgt is None:
        tgt = expert_at(expert_lib, state.seq_idx,
                        state.start_ind + state.cur_t + 1)
    kin = E.fk(topo, model, qpos)
    c = cfg.obs_coord
    qvel = torch.cat([transform_vec(qvel[:, :3], qpos[:, 3:7], c),
                      qvel[:, 3:]], 1)
    curr_root_quat = quat_mul(qpos[:, 3:7], quat_inv(base_rot))
    hq = heading_quat(curr_root_quat)
    target_qpos = tgt["qpos"]
    target_quat = tgt["wbquat"].reshape(B, -1, 4)
    target_jpos = tgt["wbpos"].reshape(B, -1, 3)
    target_root_quat = quat_mul(target_qpos[:, 3:7], quat_inv(base_rot))
    obs = [hq, target_qpos[:, 2:3], qpos[:, 2:3],
           target_qpos[:, 2:3] - qpos[:, 2:3]]
    cur_quats = torch.cat([curr_root_quat[:, None],
                           qpos[:, 7:].reshape(B, -1, 4)], 1)
    tgt_quats = torch.cat([target_root_quat[:, None],
                           target_qpos[:, 7:].reshape(B, -1, 4)], 1)
    obs.append(quat_mul(quat_inv(cur_quats), tgt_quats).reshape(B, -1))
    qvel = torch.cat([transform_vec(qvel[:, :3], curr_root_quat, c),
                      qvel[:, 3:]], 1)
    obs.append(qvel if cfg.obs_vel == "full" else qvel[:, :6])
    obs.append(wrap_to_pi(heading_angle(target_root_quat)
                          - heading_angle(curr_root_quat))[:, None])
    obs.append(transform_vec(target_root_quat[:, :3] - qpos[:, :3],
                             curr_root_quat, c)[:, :2])
    crq = curr_root_quat[:, None]
    curr_jpos = kin["xpos"]
    for v in (curr_jpos - qpos[:, None, :3], target_jpos - curr_jpos):
        obs.append(_component_major(transform_vec(v, crq, c)))
    cur_quat = kin["xquat"]
    obs.append(quat_mul(quat_inv(hq)[:, None], cur_quat).reshape(B, -1))
    obs.append(quat_mul(quat_inv(cur_quat), target_quat).reshape(B, -1))
    if cfg.has_shape and cfg.has_shape_obs and shape_obs is not None:
        obs.append(shape_obs)
    return torch.cat(obs, 1)


def obs_v3(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
           expert_lib, shape_obs=None) -> torch.Tensor:
    """Obs v2 stacked over `fut_frames` future frames `obs_skip` apart
    (uhc_tpu/envs/humanoid_im.py:680-685), each target clamped to the
    clip's last frame."""
    v2 = dataclasses.replace(cfg, obs_v=2)
    return torch.cat([
        obs_v12(topo, model, v2, state, expert_lib, shape_obs, delta_t=i)
        for i in range(0, cfg.fut_frames * cfg.obs_skip, cfg.obs_skip)], 1)


def observe(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
            expert_lib, tgt=None) -> torch.Tensor:
    """Observation dispatch over a shared or per-env model
    (uhc_tpu/envs/humanoid_im.py:653-692). A shape-conditioned config
    appends each env's shape observation from the library; a library
    built without one is an error. Obs v2 of the ball family
    (robot_ball) is v2_quat. Each call counts as the tracer's `obs`."""
    count("obs")
    shape_obs = None
    if cfg.has_shape:
        if "shape_obs" not in expert_lib:
            raise ValueError(
                "cfg.has_shape is set but the expert library has no "
                "'shape_obs': build it with data.dataset."
                "build_shaped_library, not build_expert_library")
        shape_obs = expert_lib["shape_obs"][state.seq_idx]
    if cfg.obs_v == 2 and cfg.robot_ball:
        return obs_v2_quat(topo, model, cfg, state, expert_lib, shape_obs,
                           tgt)
    if cfg.obs_v in (1, 2):
        return obs_v12(topo, model, cfg, state, expert_lib, shape_obs, tgt)
    if cfg.obs_v == 0:
        return obs_v0(topo, model, cfg, state, expert_lib, tgt)
    if cfg.obs_v == 3:
        return obs_v3(topo, model, cfg, state, expert_lib, shape_obs)
    fn = {4: obs_v4, 5: obs_v5, 6: obs_v6}.get(cfg.obs_v)
    if fn is None:
        raise NotImplementedError(f"obs_v={cfg.obs_v}")
    return fn(topo, model, cfg, state, expert_lib, shape_obs, tgt)


def get_obs(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
            expert_lib, tgt=None) -> torch.Tensor:
    """(B, obs_dim) observations; `model` is shared or a library (the JAX
    get_obs_batched: the batch axis is explicit here)."""
    return observe(topo, env_models(model, state.seq_idx), cfg, state,
                   expert_lib, tgt=tgt)


def shape_obs_dim(topo: Topology, cfg: EnvConfig) -> int:
    """Width of the shape observation: beta(16) if has_pca + gender(1) +
    weight(1)? + bone lengths(nb)?."""
    return ((16 if cfg.has_pca else 0) + 1
            + (1 if cfg.has_weight else 0)
            + (topo.nbody if cfg.has_bone_length else 0))


def obs_dim(topo: Topology, cfg: EnvConfig) -> int:
    """Width of `get_obs` (uhc_tpu/envs/humanoid_im.py:719-750)."""
    nb, nq, nv = topo.nbody, topo.nq, topo.nv
    vel = nv if cfg.obs_vel == "full" else 6
    shape_all = shape_obs_dim(topo, cfg) if cfg.has_shape else 0
    shape = shape_all if cfg.has_shape_obs else 0
    if cfg.obs_v == 2 and cfg.robot_ball:
        # v2_quat: heading quat, 3 heights, a quat difference per body,
        # qvel, heading + xy, the two jpos blocks, the two body-quat blocks
        return 4 + 3 + 4 * nb + vel + 3 + 6 * nb + 8 * nb + shape
    if cfg.obs_v == 0:
        return ((1 if cfg.obs_heading else 0) + (nq - 2) + vel + topo.ndof
                + (1 if cfg.obs_phase else 0))
    if cfg.obs_v == 1:
        return (4 + 3 * (nq - 2) + vel + 1 + 2 + 3 * nb * 4 + 4 * nb * 2
                + shape)
    if cfg.obs_v == 2:
        return (4 + 3 * (nq - 2) + vel + 1 + 2 + 3 * nb * 2 + 4 * nb * 2
                + shape)
    if cfg.obs_v == 3:
        return cfg.fut_frames * obs_dim(topo, dataclasses.replace(cfg,
                                                                   obs_v=2))
    if cfg.obs_v == 4:
        # global 4 + 3·5 + 6 + 3 (+ shape: v4 reads has_shape alone) and
        # (nb-1) local rows of 3·3 + 3 + 3·2 + 4·2
        return 28 + shape_all + (nb - 1) * 26
    if cfg.obs_v == 5:
        return 3 * (nq - 2) + vel + 1 + 2 + 3 * nb * 2 + 4 * nb * 2 + shape
    if cfg.obs_v == 6:
        return (3 + 1 + 4 + vel + 2 * nb + 3 * (nb - 1) + 4 * (nb - 1) * 2
                + shape)
    raise NotImplementedError(f"obs_v={cfg.obs_v}")


# ---------------------------------------------------------------------------
# Termination + step + reset
# ---------------------------------------------------------------------------


def calc_body_diff(topo: Topology, model: Model, state: EnvState,
                   expert_lib, jpos_diffw) -> torch.Tensor:
    """Weighted mean joint-position distance (B,)."""
    exp = expert_at(expert_lib, state.seq_idx, state.start_ind + state.cur_t)
    kin = E.fk(topo, model, state.qpos)
    B = state.qpos.shape[0]
    diff = (kin["xpos"] - exp["wbpos"].reshape(B, -1, 3)) * jpos_diffw[:, None]
    per_body = torch.linalg.vector_norm(diff, dim=2)
    mask = (jpos_diffw > 0).to(per_body.dtype)
    return (per_body * mask).sum(1) / mask.sum()


def env_post_step(topo: Topology, model: Model, cfg: EnvConfig,
                  state: EnvState, action, expert_lib, jpos_diffw,
                  body_diffw, train: bool = True):
    """Termination + reward + obs after the physics advanced; `model` is
    shared or per env (already gathered, see `env_models`). A blown-up
    env (non-finite qpos or |qvel| > 1e4) fails with zero reward."""
    qpos, qvel, cur_t = state.qpos, state.qvel, state.cur_t
    length = expert_lib["len"][state.seq_idx]
    t_max = cfg.t_max if cfg.t_max > 0 else 10 ** 9
    wlen = torch.clamp(length - state.start_ind, max=t_max)
    thresh = cfg.body_diff_thresh if train else cfg.body_diff_thresh_test
    if cfg.env_term_body == "body":
        fail = calc_body_diff(topo, model, state, expert_lib,
                              jpos_diffw) > thresh
    elif cfg.env_term_body == "root":
        fail = qpos[:, 2] < expert_lib["height_lb"][state.seq_idx] - 0.1
    else:
        kin = E.fk(topo, model, qpos)
        fail = kin["xpos"][:, head_index(topo), 2] < \
            expert_lib["head_height_lb"][state.seq_idx] - 0.1
    blown = (~torch.isfinite(qpos).all(1)) | (qvel.abs().amax(1) > 1e4)
    fail = fail | blown
    end = (cur_t >= cfg.env_episode_len) | \
        (cur_t >= wlen + cfg.env_expert_trail_steps - 1)
    done = fail | end
    percent = cur_t.to(qpos.dtype) / torch.clamp(wlen - 1, min=1).to(
        qpos.dtype)
    state = dataclasses.replace(state, done=done, fail=fail, end=end,
                                percent=percent)
    from uhc_tpu_torch.rewards.reward_function import get_reward_fn

    aux = {"jpos_diffw": jpos_diffw, "body_diffw": body_diffw}
    reward, terms = get_reward_fn(cfg.reward_id)(
        topo, model, cfg, state, action, expert_lib, aux)
    # a step that blew up fails and earns nothing: its reward, computed
    # from a non-finite or runaway state, would be NaN and spread through
    # the whole batch's advantages (the JAX package returns the NaN)
    reward = torch.where(blown, 0.0, reward)
    terms = torch.where(blown[:, None], 0.0, terms)
    with span("obs"):
        obs = observe(topo, model, cfg, state, expert_lib)
    return state, obs, reward, terms, done


def env_step(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
             action, expert_lib, jpos_diffw, body_diffw, rfc_rate=1.0,
             train: bool = True, obj_model=None):
    """One 30 Hz control step with the exact per-substep solver; `model`
    is shared or a library. With `obj_model` (physics.objects.ObjModel)
    the scene objects are dynamic bodies stepped with the humanoid
    (uhc_tpu/envs/humanoid_im.py:812-835); otherwise obj_qpos plays the
    library's track back."""
    model = env_models(model, state.seq_idx)
    prev_bquat = get_body_quat(state.qpos)
    tgt = expert_at(expert_lib, state.seq_idx,
                    state.start_ind + state.cur_t + 1)
    if obj_model is not None and state.obj_qpos is not None:
        obj_qvel = (state.obj_qvel if state.obj_qvel is not None
                    else zero_obj_qvel(state.obj_qpos))
        qpos, qvel, obj_qpos, obj_qvel = do_simulation(
            topo, model, cfg, state.qpos, state.qvel, action,
            tgt["qpos"][:, 7:], rfc_rate,
            obj=(obj_model, state.obj_qpos, obj_qvel))
    else:
        qpos, qvel = do_simulation(topo, model, cfg, state.qpos, state.qvel,
                                   action, tgt["qpos"][:, 7:], rfc_rate)
        obj_qpos = tgt.get("obj_pose", state.obj_qpos)
        obj_qvel = state.obj_qvel
    state = dataclasses.replace(state, qpos=qpos, qvel=qvel,
                                prev_qpos=state.qpos, cur_t=state.cur_t + 1,
                                prev_bquat=prev_bquat, obj_qpos=obj_qpos,
                                obj_qvel=obj_qvel)
    return env_post_step(topo, model, cfg, state, action, expert_lib,
                         jpos_diffw, body_diffw, train)


def make_env_step_batched(topo: Topology, cfg: EnvConfig,
                          fused_model: Model = None):
    """Batched control step. With `fused_model` (the model, or the model
    library, the episode will simulate) the substeps run through a
    control-step kernel, chosen by the tree's size, the config and
    UHC_TPU_LANE / UHC_TPU_LANE_BIG when the step is built, as in the JAX
    package (uhc_tpu/envs/humanoid_im.py:853-951), on every tree it
    builds (`csrc/build.py`, -DNB):
    - every tree of up to 32 bodies (the 24-body humanoid, remove_toe's
      22): "1" (the default) gives K1 (`ControlStep`) with the production
      (1, 2) PCG schedule, UHC_TPU_LANE=0 gives K2's head/tail split
      (`ControlStepSplit`) with symmetric PCG-2;
    - 33 to 52 bodies (masterfoot, SMPL-H): K1d, the big-tree build of
      the same kernel, with the symmetric (2, 2) schedule; UHC_TPU_LANE=0
      or UHC_TPU_LANE_BIG=0 gives K2 on the big tree at PCG-2;
    - more than 52 bodies (the 55-body SMPL-X): K2 on that tree's build at
      PCG-2 whatever UHC_TPU_LANE / UHC_TPU_LANE_BIG say (the JAX lane
      route stops at 52); a model library there runs the plain chain, as
      the JAX package runs XLA;
    - explicit RFC or per-joint meta-PD (`meta_pd_joint`) run on the
      lane route only: K1f, the same `ControlStep` with its wrench and
      per-dof gain operands, at the tree's schedule ((1, 2) up to 32
      bodies, (2, 2) on 33 to 52). Explicit RFC over a model library and
      either of them under UHC_TPU_LANE=0 (or UHC_TPU_LANE_BIG=0 on a big
      tree, or on a tree of more than 52 bodies) run the plain chain,
      where the JAX package runs XLA (`fused_compatible`; the hull tables
      are per shape);
    - torque control (action_type "torque", the ball family) runs no
      kernel on any tree: `solver.torque_substeps`, one exact solve a
      substep, batched over the envs, as the JAX package runs its generic
      path there (uhc_tpu/envs/humanoid_im.py:862,905-910).
    UHC_TPU_MERGEJ6=1, which makes the JAX lane kernel project every
    wrench in one contraction, picks the same kernel here: K1's phase G
    already projects each body's bias and external wrench in one pass.
    A library takes the per-env variant of the same kernels (K1e, or K2
    over the library: the JAX package runs a library under UHC_TPU_LANE=0
    on its XLA chain), with each env's seq_idx; a library with a leaf
    outside `PE_MODEL_LEAVES` batched (a design population, which batches
    every leaf) runs the plain chain, as the JAX package runs XLA
    (uhc_tpu/envs/humanoid_im.py:888-904). Without `fused_model`, or
    where the JAX package runs XLA, the substeps run through the plain PCG
    chain with 5 iterations (the JAX default). The returned step carries
    the kernel wrapper it calls as `step.kernel` (None for the plain
    chain). It runs in the tracer's spans physics (everything up to the
    kernel's return) and post (`env_post_step`)."""
    kernel = None
    if fused_model is not None and cfg.action_type != "torque":
        from uhc_tpu_torch.physics.control_step import (PE_MODEL_LEAVES,
                                                        lane_only)

        big = LANE_SMALL_MAX < topo.nbody <= LANE_BIG_MAX
        split_only = topo.nbody > LANE_BIG_MAX
        library = model_is_batched(fused_model)
        per_env_leaves = not library or all(
            a is None or k in PE_MODEL_LEAVES
            for k, a in model_batch_axes(fused_model).items())
        lane = not split_only and os.environ.get(
            "UHC_TPU_LANE", "1") == "1" and (
            not big or os.environ.get("UHC_TPU_LANE_BIG", "1") == "1")
        # where the JAX package runs its XLA chain: explicit RFC or
        # per-joint meta-PD off the lane route, explicit RFC over a
        # library, a library on the head/tail-only trees, a library with
        # leaves the per-env kernel does not gather
        on_xla = (lane_only(cfg) and (
            not lane or (library and S.explicit_rfc(cfg)))) or (
            split_only and library) or not per_env_leaves
        if lane and not on_xla:
            from uhc_tpu_torch.physics.control_step import ControlStep

            # big trees keep the symmetric count, as in the JAX package
            kernel = ControlStep(topo, cfg, fused_model,
                                 pcg_iters=(2, 2) if big else (1, 2))
        elif not on_xla:
            from uhc_tpu_torch.physics.control_step_split import \
                ControlStepSplit

            kernel = ControlStepSplit(topo, cfg, fused_model, pcg_iters=2)

    if kernel is not None:
        def sim(model, states, actions, target_base, rfc_rate):
            seq = (None if kernel.num_models is None
                   else states.seq_idx.to(torch.int32).contiguous())
            return kernel(states.qpos, states.qvel, actions, target_base,
                          rfc_rate, seq)
    else:
        def sim(model, states, actions, target_base, rfc_rate):
            return S.do_simulation(topo, cfg, model, states.qpos,
                                   states.qvel, actions, target_base,
                                   rfc_rate, 5)

    def step(model: Model, states: EnvState, actions, expert_lib,
             jpos_diffw, body_diffw, rfc_rate=1.0, train: bool = True):
        with span("physics"):
            m = env_models(model, states.seq_idx)
            prev_bquat = get_body_quat(states.qpos)
            tgt = expert_at(expert_lib, states.seq_idx,
                            states.start_ind + states.cur_t + 1)
            qpos, qvel = sim(m, states, actions,
                             tgt["qpos"][:, 7:].contiguous(), rfc_rate)
            # kinematic playback of the library's object track
            states = dataclasses.replace(
                states, qpos=qpos, qvel=qvel, prev_qpos=states.qpos,
                cur_t=states.cur_t + 1, prev_bquat=prev_bquat,
                obj_qpos=tgt.get("obj_pose", states.obj_qpos))
        with span("post"):
            return env_post_step(topo, m, cfg, states, actions, expert_lib,
                                 jpos_diffw, body_diffw, train)

    step.kernel = kernel
    return step


def match_heading_and_pos(qpos_1, qpos_2, base_rot):
    """Align qpos_2's heading and xy to qpos_1 (both (B, nq))."""
    count("host_sync")
    base_rot = qpos_1.new_tensor(base_rot)
    heading_1 = heading_quat(quat_mul(qpos_1[:, 3:7], quat_inv(base_rot)))
    new_quat = quat_mul(heading_1, de_heading(qpos_2[:, 3:7]))
    return torch.cat([qpos_1[:, :2], qpos_2[:, 2:3], new_quat,
                      qpos_2[:, 7:]], 1)


def zero_obj_qvel(obj_qpos):
    """Objects at rest: (B, 6·NO) zeros for (B, 7·NO) poses."""
    return obj_qpos.new_zeros(obj_qpos.shape[:-1]
                              + (obj_qpos.shape[-1] // 7 * 6,))


def env_reset(topo: Topology, model: Model, cfg: EnvConfig, seq_idx,
              expert_lib, neutral_qpos, neutral_qvel, start_ind=None,
              train: bool = True, generator: torch.Generator = None,
              dynamic_obj: bool = False):
    """reset_model for a batch of sequences `seq_idx` (B,): the expert
    window-start frame, plus (train only) joint noise and, with
    reactive_v=1, the heading-matched neutral pose with prob reactive_rate.
    A library with an object track starts the objects at that frame's
    poses, at rest when `dynamic_obj` (obj_qvel zeros), else without
    velocities (kinematic playback)."""
    dev = expert_lib["len"].device
    seq_idx = torch.as_tensor(seq_idx, dtype=torch.int64, device=dev)
    B = seq_idx.shape[0]
    length = expert_lib["len"][seq_idx]
    if start_ind is None:
        if train:
            hi = torch.clamp(length - cfg.t_min, min=1)
            u = torch.rand(B, generator=generator, device=dev)
            start_ind = (u * hi).to(torch.int64)
        else:
            start_ind = torch.zeros(B, dtype=torch.int64, device=dev)
    start_ind = torch.as_tensor(start_ind, dtype=torch.int64,
                                device=dev).expand(B).clone()
    exp0 = expert_at(expert_lib, seq_idx, start_ind)
    init_qpos, init_qvel = exp0["qpos"].clone(), exp0["qvel"].clone()
    if train and cfg.env_init_noise > 0:
        init_qpos[:, 7:] += cfg.env_init_noise * torch.randn(
            init_qpos[:, 7:].shape, generator=generator, device=dev)
    if cfg.reactive_v == 1 and train:
        use = torch.rand(B, generator=generator, device=dev) < \
            cfg.reactive_rate
        neutral = match_heading_and_pos(
            init_qpos, neutral_qpos.expand(B, -1), cfg.base_rot)
        init_qpos = torch.where(use[:, None], neutral, init_qpos)
        init_qvel = torch.where(use[:, None], neutral_qvel.expand(B, -1),
                                init_qvel)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    obj_qpos = exp0.get("obj_pose")
    return EnvState(
        qpos=init_qpos, qvel=init_qvel, prev_qpos=init_qpos, cur_t=zero,
        start_ind=start_ind, seq_idx=seq_idx,
        prev_bquat=get_body_quat(init_qpos), done=false, fail=false.clone(),
        end=false.clone(), percent=init_qpos.new_zeros(B), obj_qpos=obj_qpos,
        obj_qvel=(zero_obj_qvel(obj_qpos)
                  if dynamic_obj and obj_qpos is not None else None))
