"""Hierarchical kinematic-policy environment, batched over envs (PyTorch
twin of uhc_tpu.envs.humanoid_kin, reference uhc/envs/humanoid_kin_v1.py).

A kinematic action (80 = 74 qpos-style dims + 6 root velocities) is
integrated by `step_ar` into the next target qpos; its FK is the "expert"
frame fed to a frozen copycat policy (`cc_policy_fn`, normalization and
weights baked in), whose mean action drives the body through the exact
chain (`humanoid_im.do_simulation`, no kernel in either package). The kin
policy observes `get_ar_obs_v1`: the sim state against the FK of the
ground-truth next frame.

State is a `KinEnvState` of (B, ...) tensors. Resets draw nothing (every
episode starts at its context's frame 0), so no generator is needed here.
Scene objects ride the state as in the copycat env: a track played back,
or dynamic bodies stepped with the humanoid when `kin_env_step` gets an
`obj_model`.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Callable, Dict, Tuple

import torch

from uhc_tpu_torch.config.config import EnvConfig
from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.envs.expert import qpos_fk_frame
from uhc_tpu_torch.maths import (heading_quat, quat_from_rotvec, quat_inv,
                                 quat_mul, quat_normalize, quat_rotate,
                                 wrap_to_pi)
from uhc_tpu_torch.physics import engine as E
from uhc_tpu_torch.physics.model import Model, Topology
from uhc_tpu_torch.smpl.constants import HEAD_INDEX, head_index


@dataclasses.dataclass(frozen=True)
class KinConfig:
    """Static kin-env hyper-parameters (the uhm_config.py fields the env
    reads)."""

    pose_delta: bool = False          # model_specs.pose_delta
    remove_base: bool = True          # cfg.remove_base (step_ar)
    env_episode_len: int = 100000
    env_term_body: str = "body"
    reward_id: str = "dynamic_supervision_v1"
    reward_weights: Tuple[Tuple[str, Any], ...] = ()
    base_rot: Tuple[float, ...] = (0.7071, 0.7071, 0.0, 0.0)

    def rw(self, name: str, default):
        for k, v in self.reward_weights:
            if k == name:
                return v
        return default


@dataclasses.dataclass
class KinEnvState:
    qpos: Any          # (B, nq)
    qvel: Any          # (B, nv)
    prev_qpos: Any     # (B, nq)
    prev_bquat: Any    # (B, nb*4)
    prev_hpos: Any     # (B, 7) head pos + quat before the step
    target_qpos: Any   # (B, nq) the kin policy's integrated target
    cur_t: Any         # (B,) int64
    start_ind: Any     # (B,) int64
    seq_idx: Any       # (B,) int64
    done: Any
    fail: Any
    end: Any
    percent: Any
    # scene objects (humanoid_kin_v1.py:477 get_obj_qpos): (B, 7·NO)
    # poses, dynamic with (B, 6·NO) velocities when stepped with an
    # obj_model
    obj_qpos: Any = None
    obj_qvel: Any = None


KIN_QPOS_LM = 74     # humanoid_kin_v1.py:263 qpos_lm
KIN_POSE_START = 7


def kin_action_dim(topo: Topology = None) -> int:
    """74 qpos-style dims + 6 root velocities (step_ar's layout)."""
    return KIN_QPOS_LM + 6


def step_ar(cfg: KinConfig, qpos, a, dt: float = 1.0 / 30.0):
    """Integrate kinematic actions (B, 80) into the next target qpos
    (humanoid_kin_v1.py:260-295): a[0] the target height, a[1:5] root-quat
    slots (overwritten), a[5:74] the body pose (absolute, or a delta with
    pose_delta), a[74:77] root linear velocity in the heading frame,
    a[77:80] root angular velocity in the root frame."""
    base_rot = qpos.new_tensor(cfg.base_rot)
    curr_pos, curr_rot = qpos[:, :3], qpos[:, 3:7]
    if cfg.remove_base:
        curr_rot = quat_mul(curr_rot, quat_inv(base_rot))
    curr_heading = heading_quat(curr_rot)

    body_pose = a[:, KIN_POSE_START - 2:KIN_QPOS_LM]
    if cfg.pose_delta:
        body_pose = wrap_to_pi(body_pose + qpos[:, KIN_POSE_START:])
    root_qvel = a[:, KIN_QPOS_LM:]
    linv = quat_rotate(curr_heading, root_qvel[:, :3])
    xy = curr_pos[:, :2] + linv[:, :2] * dt
    angv = quat_rotate(curr_rot, root_qvel[:, 3:6])
    new_rot = quat_mul(quat_from_rotvec(angv * dt), curr_rot)
    if cfg.remove_base:
        new_rot = quat_mul(new_rot, base_rot)
    return torch.cat([xy, a[:, :1], quat_normalize(new_rot), body_pose], 1)


def context_at(context_lib: Dict[str, Any], seq_idx, t) -> dict:
    """The GT context frame (ar_context): the expert library's features,
    with `ar_qpos` / `ar_bquat` the GT fields where no pretrained-ARNet
    dump was loaded."""
    frame = H.expert_at(context_lib, seq_idx, t)
    frame.setdefault("ar_qpos", frame["qpos"])
    frame.setdefault("ar_bquat", frame["bquat"])
    return frame


def head_pose_of(context_lib, seq_idx, t):
    """(B, 7) head pos + quat of the GT context at frames t (ar_context
    head_pose; kin-stack contexts are SMPL-24, HEAD_INDEX)."""
    frame = H.expert_at(context_lib, seq_idx, t)
    B = frame["wbpos"].shape[0]
    return torch.cat([frame["wbpos"].reshape(B, -1, 3)[:, HEAD_INDEX],
                      frame["wbquat"].reshape(B, -1, 4)[:, HEAD_INDEX]], 1)


def get_ar_obs_v1(topo: Topology, model: Model, cc_cfg: EnvConfig,
                  state: KinEnvState, context_lib):
    """Kin-policy observation (humanoid_kin_v1.py:162 get_ar_obs_v1): the
    sim state against the FK of the GT next frame."""
    gt = context_at(context_lib, state.seq_idx,
                    state.start_ind + state.cur_t + 1)
    return ar_obs_from(topo, model, cc_cfg, state.qpos, state.qvel,
                       gt["qpos"])


def ar_obs_from(topo: Topology, model: Model, cc_cfg: EnvConfig, qpos, qvel,
                input_qpos):
    """The feature function behind get_ar_obs_v1: (sim qpos, qvel, target
    GT frame) -> obs. Its layout is the copycat obs v2 without shape
    (the reference's double linear-velocity transform, target_root_quat[:3]
    read as rel_pos, component-major position blocks), so it is
    `humanoid_im.obs_v12` at obs_v 2 on the target's FK. Shared with the
    kin net's env-layout supervised training (`KinNetSpecs.env_obs`)."""
    cfg = dataclasses.replace(cc_cfg, obs_v=2, has_shape=False)
    return H.obs_v12(topo, model, cfg,
                     types.SimpleNamespace(qpos=qpos, qvel=qvel), None,
                     tgt=qpos_fk_frame(topo, model, input_qpos))


def ar_obs_dim(topo: Topology, cc_cfg: EnvConfig) -> int:
    nb, nq, nv = topo.nbody, topo.nq, topo.nv
    vel = nv if cc_cfg.obs_vel == "full" else 6
    return 4 + 3 * (nq - 2) + vel + 3 + 3 * nb * 2 + 4 * nb * 2


def calc_body_diff_sum(topo, model, qpos, tgt_wbpos, jpos_diffw):
    """Weighted SUM of per-body distances (B,) (humanoid_kin_v1.py:452:
    the kin env sums where the copycat env means; threshold 10)."""
    kin = E.fk(topo, model, qpos)
    diff = (kin["xpos"] - tgt_wbpos.reshape(qpos.shape[0], -1, 3)) \
        * jpos_diffw[:, None]
    return torch.linalg.vector_norm(diff, dim=2).sum(1)


def _head_pose(topo, kin):
    hidx = head_index(topo)
    return torch.cat([kin["xpos"][:, hidx], kin["xquat"][:, hidx]], 1)


def kin_env_step(topo: Topology, model: Model, kin_cfg: KinConfig,
                 cc_cfg: EnvConfig, state: KinEnvState, kin_action,
                 context_lib, cc_policy_fn: Callable, jpos_diffw,
                 rfc_rate=1.0, train: bool = True, obj_model=None):
    """One 30 Hz hierarchical step (humanoid_kin_v1.py:297) of every env:
    step_ar, the frozen controller's mean on the copycat obs of the
    integrated target, the exact chain, termination, the UHM reward ->
    (state', obs, reward (B,), reward terms (B, n), done (B,)). A blown-up
    env (non-finite qpos or |qvel| > 1e4) fails with zero reward, as in
    the port's copycat env (the JAX package returns the NaN)."""
    from uhc_tpu_torch.rewards.uhm_rewards import get_uhm_reward_fn

    prev_qpos, prev_bquat = state.qpos, H.get_body_quat(state.qpos)
    prev_hpos = _head_pose(topo, E.fk(topo, model, state.qpos))
    next_qpos = step_ar(kin_cfg, state.qpos, kin_action)
    target = qpos_fk_frame(topo, model, next_qpos)
    cc_obs = H.get_obs(topo, model, cc_cfg, state, context_lib, tgt=target)
    cc_a = cc_policy_fn(cc_obs)

    if obj_model is not None and state.obj_qpos is not None:
        obj_qvel = (state.obj_qvel if state.obj_qvel is not None
                    else H.zero_obj_qvel(state.obj_qpos))
        qpos, qvel, obj_qpos, obj_qvel = H.do_simulation(
            topo, model, cc_cfg, state.qpos, state.qvel, cc_a,
            next_qpos[:, 7:], rfc_rate,
            obj=(obj_model, state.obj_qpos, obj_qvel))
    else:
        qpos, qvel = H.do_simulation(topo, model, cc_cfg, state.qpos,
                                     state.qvel, cc_a, next_qpos[:, 7:],
                                     rfc_rate)
        obj_qpos, obj_qvel = state.obj_qpos, state.obj_qvel
    state = dataclasses.replace(
        state, qpos=qpos, qvel=qvel, prev_qpos=prev_qpos,
        prev_bquat=prev_bquat, prev_hpos=prev_hpos, target_qpos=next_qpos,
        cur_t=state.cur_t + 1, obj_qpos=obj_qpos, obj_qvel=obj_qvel)

    jw = jpos_diffw.to(qpos.dtype)
    fail = calc_body_diff_sum(topo, model, qpos, target["wbpos"], jw) > 10.0
    if train:
        gt = context_at(context_lib, state.seq_idx,
                        state.start_ind + state.cur_t)
        fail = fail | (calc_body_diff_sum(topo, model, qpos, gt["wbpos"],
                                          jw) > 10.0)
    blown = (~torch.isfinite(qpos).all(1)) | (qvel.abs().amax(1) > 1e4)
    fail = fail | blown

    length = context_lib["len"][state.seq_idx] - 1
    end = (state.cur_t >= cc_cfg.env_episode_len) | \
        (state.cur_t + state.start_ind >= length)
    done = fail | end
    percent = state.cur_t.to(qpos.dtype) / length.to(qpos.dtype)
    state = dataclasses.replace(state, done=done, fail=fail, end=end,
                                percent=percent)
    reward, terms = get_uhm_reward_fn(kin_cfg.reward_id)(
        topo, model, kin_cfg, cc_cfg, state, context_lib)
    reward = torch.where(blown, 0.0, reward)
    terms = torch.where(blown[:, None], 0.0, terms)
    obs = get_ar_obs_v1(topo, model, cc_cfg, state, context_lib)
    return state, obs, reward, terms, done


def kin_env_reset(topo: Topology, model: Model, kin_cfg: KinConfig, seq_idx,
                  context_lib, use_gt_init: bool = True,
                  dynamic_obj: bool = False) -> KinEnvState:
    """reset_model (humanoid_kin_v1.py:379) of sequences `seq_idx` (B,):
    each starts at its context's frame 0 (GT, or the ARNet init where
    loaded and use_gt_init is off), objects at that frame's poses, at rest
    when dynamic."""
    dev = context_lib["len"].device
    seq_idx = torch.as_tensor(seq_idx, dtype=torch.int64, device=dev)
    B = seq_idx.shape[0]
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    frame0 = context_at(context_lib, seq_idx, zero)
    init_qpos = frame0["qpos"] if use_gt_init else frame0["ar_qpos"]
    init_qvel = frame0["qvel"]
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    obj_qpos = frame0.get("obj_pose")
    return KinEnvState(
        qpos=init_qpos, qvel=init_qvel, prev_qpos=init_qpos,
        prev_bquat=H.get_body_quat(init_qpos),
        prev_hpos=_head_pose(topo, E.fk(topo, model, init_qpos)),
        target_qpos=init_qpos, cur_t=zero, start_ind=zero.clone(),
        seq_idx=seq_idx, done=false, fail=false.clone(), end=false.clone(),
        percent=init_qpos.new_zeros(B), obj_qpos=obj_qpos,
        obj_qvel=(H.zero_obj_qvel(obj_qpos)
                  if dynamic_obj and obj_qpos is not None else None))
