"""Copycat (motion imitation) environment, batched over envs (PyTorch twin
of uhc_tpu.envs.humanoid_im).

The env is a set of functions over an `EnvState` of (B, ...) tensors and a
device-resident expert library. One 30 Hz control step is frame_skip
stable-PD substeps at 450 Hz; `make_env_step_batched` routes them through
a hand-written CUDA control-step kernel (K1 `physics.control_step`, or K2
`physics.control_step_split` under UHC_TPU_LANE=0; K1f for explicit RFC
and per-joint meta-PD; K1d on the 48-body masterfoot and 52-body SMPL-H
trees) when given the model to bake, else through the plain PCG chain.
Obs, reward and termination read the tree's sizes from its topology.

The model is shared, or a per-sequence library (shape-conditioned or
domain-randomized training, `data.dataset.build_shaped_library` /
`build_dr_library`): each env then simulates, observes and is rewarded
on its own sequence's model, gathered by its seq_idx (`env_models`), and
the kernels take the library with seq_idx (K1e).

Ported: obs v1 and v2 with the shape observation, the world_rfc_implicit
and world_rfc_explicit rewards, implicit and explicit RFC, plain,
meta-PD and per-joint meta-PD, body-diff termination.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

from uhc_tpu_torch.config.config import EnvConfig
from uhc_tpu_torch.maths import (de_heading, heading_angle, heading_quat,
                                 quat_from_euler_zyx, quat_inv, quat_mul,
                                 transform_vec, wrap_to_pi)
from uhc_tpu_torch.physics import engine as E
from uhc_tpu_torch.physics import solver as S
from uhc_tpu_torch.physics.model import (Model, Topology, env_models,
                                         model_batch_axes, model_is_batched,
                                         model_per_env)
from uhc_tpu_torch.smpl.constants import head_index


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


def state_where(mask, new: EnvState, old: EnvState) -> EnvState:
    """Per-env select between two states: `new` where the (B,) mask is
    true."""
    out = {}
    for f in dataclasses.fields(EnvState):
        a, b = getattr(new, f.name), getattr(old, f.name)
        m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
        out[f.name] = torch.where(m, a, b)
    return EnvState(**out)


PER_SEQ_KEYS = ("len", "height_lb", "head_height_lb", "beta", "gender",
                "shape_obs", "weight")

# Trees with a control-step kernel, as the JAX package routes them
# (uhc_tpu/envs/humanoid_im.py:873-877): the 24-body SMPL humanoid, and
# 33 to 52 bodies on the big-tree path (masterfoot, SMPL-H).
SMPL_BODIES, LANE_BIG_BODIES = 24, range(33, 53)



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
                  action, target_base, rfc_rate):
    """One control step with an exact factorization at every substep (the
    reference path; `make_env_step_batched` uses the PCG chain). `model`
    is shared or per env."""
    from uhc_tpu_torch.physics import linalg as LA

    S.check_supported(cfg)
    model = model_per_env(model, qpos.shape[0])
    ndof, vf_dim, _ = S.action_dims(topo, cfg)
    kp_scale, kd_scale = S.gain_scales(cfg, action, ndof, vf_dim)
    vf_body = S.explicit_wrench(topo, cfg, model, action, ndof, vf_dim)
    for i in range(cfg.frame_skip):
        if cfg.action_v == 1:
            base = qpos[:, 7:] + wrap_to_pi(target_base - qpos[:, 7:])
        else:
            base = torch.zeros_like(qpos[:, 7:])
        target_pos = base + action[:, :ndof]
        qfrc = S.implicit_rfc(cfg, qpos, action, ndof, rfc_rate)
        kp = model.jkp * kp_scale[:, i]
        kd = model.jkd * kd_scale[:, i]
        out = E.assemble(topo, model, qpos, qvel, target_pos, kp, kd, qfrc,
                         cfg.self_collision, vf_body, S.vf_gate_mode(cfg))
        qacc_des = LA.blocked_cho_solve(LA.blocked_cholesky(out["A_pd"]),
                                        out["pd_rhs"])
        tau = E.pd_torque_from_accel(model, qvel, out["qpos_err"], kp, kd,
                                     qacc_des)
        rhs = out["rhs_base"].clone()
        rhs[:, 6:] += tau
        qacc = LA.blocked_cho_solve(LA.blocked_cholesky(out["A_fd"]), rhs)
        qpos, qvel = E.integrate(model, qpos, qvel, qacc)
    return qpos, qvel


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------


def get_body_quat(qpos: torch.Tensor) -> torch.Tensor:
    """Root quat + per-joint local quats, flat (B, nb*4)."""
    B = qpos.shape[0]
    jq = quat_from_euler_zyx(qpos[:, 7:].reshape(B, -1, 3))
    return torch.cat([qpos[:, None, 3:7], jq], 1).reshape(B, -1)


def obs_v12(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
            expert_lib, shape_obs=None, tgt=None) -> torch.Tensor:
    """get_full_obs_v1 (cfg.obs_v 1) and _v2 (obs_v 2: v1 without the COM
    blocks; uhc_tpu/envs/humanoid_im.py:247-310), feature-order exact: the
    reference's double linear-velocity transform, its target_root_quat[:3]
    read as rel_pos, and component-major position blocks. `model` is
    shared or per env."""
    qpos, qvel = state.qpos, state.qvel
    B = qpos.shape[0]
    base_rot = qpos.new_tensor(cfg.base_rot)
    if tgt is None:
        tgt = expert_at(expert_lib, state.seq_idx,
                        state.start_ind + state.cur_t + 1)
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
    diff_qpos = torch.cat([
        target_qpos[:, :2], target_qpos[:, 2:3] - qpos_dh[:, 2:3],
        quat_mul(target_root_quat, quat_inv(curr_root_quat)),
        target_qpos[:, 7:] - qpos_dh[:, 7:]], 1)
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
        obs.append(transform_vec(v, crq, c).transpose(1, 2).reshape(B, -1))
    cur_quat = kin["xquat"]
    obs.append(quat_mul(quat_inv(hq)[:, None], cur_quat).reshape(B, -1))
    obs.append(quat_mul(quat_inv(cur_quat), target_quat).reshape(B, -1))
    if cfg.has_shape and cfg.has_shape_obs and shape_obs is not None:
        obs.append(shape_obs)
    return torch.cat(obs, 1)


def observe(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
            expert_lib, tgt=None) -> torch.Tensor:
    """Observation dispatch over a shared or per-env model. A
    shape-conditioned config appends each env's shape observation from
    the library; a library built without one is an error."""
    shape_obs = None
    if cfg.has_shape:
        if "shape_obs" not in expert_lib:
            raise ValueError(
                "cfg.has_shape is set but the expert library has no "
                "'shape_obs': build it with data.dataset."
                "build_shaped_library, not build_expert_library")
        shape_obs = expert_lib["shape_obs"][state.seq_idx]
    if cfg.obs_v not in (1, 2) or cfg.robot_ball:
        raise NotImplementedError(f"obs_v={cfg.obs_v} (ball joints "
                                  f"{cfg.robot_ball}) is not ported yet")
    return obs_v12(topo, model, cfg, state, expert_lib, shape_obs, tgt)


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
    nb, nq, nv = topo.nbody, topo.nq, topo.nv
    vel = nv if cfg.obs_vel == "full" else 6
    shape = (shape_obs_dim(topo, cfg)
             if cfg.has_shape and cfg.has_shape_obs else 0)
    if cfg.obs_v == 1:
        return (4 + 3 * (nq - 2) + vel + 1 + 2 + 3 * nb * 4 + 4 * nb * 2
                + shape)
    if cfg.obs_v == 2 and not cfg.robot_ball:
        return (4 + 3 * (nq - 2) + vel + 1 + 2 + 3 * nb * 2 + 4 * nb * 2
                + shape)
    raise NotImplementedError(f"obs_v={cfg.obs_v} is not ported yet")


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
    shared or per env (already gathered, see `env_models`)."""
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
    obs = observe(topo, model, cfg, state, expert_lib)
    return state, obs, reward, terms, done


def env_step(topo: Topology, model: Model, cfg: EnvConfig, state: EnvState,
             action, expert_lib, jpos_diffw, body_diffw, rfc_rate=1.0,
             train: bool = True):
    """One 30 Hz control step with the exact per-substep solver; `model`
    is shared or a library."""
    model = env_models(model, state.seq_idx)
    prev_bquat = get_body_quat(state.qpos)
    tgt = expert_at(expert_lib, state.seq_idx,
                    state.start_ind + state.cur_t + 1)
    qpos, qvel = do_simulation(topo, model, cfg, state.qpos, state.qvel,
                               action, tgt["qpos"][:, 7:], rfc_rate)
    state = dataclasses.replace(state, qpos=qpos, qvel=qvel,
                                prev_qpos=state.qpos, cur_t=state.cur_t + 1,
                                prev_bquat=prev_bquat)
    return env_post_step(topo, model, cfg, state, action, expert_lib,
                         jpos_diffw, body_diffw, train)


def make_env_step_batched(topo: Topology, cfg: EnvConfig,
                          fused_model: Model = None):
    """Batched control step. With `fused_model` (the model, or the model
    library, the episode will simulate) the substeps run through a
    control-step kernel, chosen by the tree's size, the config and
    UHC_TPU_LANE / UHC_TPU_LANE_BIG when the step is built, as in the JAX
    package (uhc_tpu/envs/humanoid_im.py:853-951):
    - 24 bodies: "1" (the default) gives K1 (`ControlStep`) with the
      production (1, 2) PCG schedule, UHC_TPU_LANE=0 gives K2's head/tail
      split (`ControlStepSplit`) with symmetric PCG-2;
    - 33 to 52 bodies (masterfoot, SMPL-H): K1d, the big-tree build of
      the same kernel, with the symmetric (2, 2) schedule; UHC_TPU_LANE=0
      or UHC_TPU_LANE_BIG=0 gives K2 on the big tree at PCG-2;
    - explicit RFC or per-joint meta-PD (`meta_pd_joint`) run on the
      lane route only: K1f, the same `ControlStep` with its wrench and
      per-dof gain operands, at the tree's schedule ((1, 2) on 24 bodies,
      (2, 2) on 33 to 52). Explicit RFC over a model library and either
      of them under UHC_TPU_LANE=0 (or UHC_TPU_LANE_BIG=0 on a big tree)
      run the plain chain, where the JAX package runs XLA
      (`fused_compatible`; the hull tables are per shape);
    - any other size raises NotImplementedError.
    UHC_TPU_MERGEJ6=1, which makes the JAX lane kernel project every
    wrench in one contraction, picks the same kernel here: K1's phase G
    already projects each body's bias and external wrench in one pass.
    A library takes the per-env variant of the same kernels (K1e, or K2
    over the library: the JAX package runs a library under UHC_TPU_LANE=0
    on its XLA chain), with each env's seq_idx. Without `fused_model`, or
    where the JAX package runs XLA, the substeps run through the plain PCG
    chain with 5 iterations (the JAX default). The returned step carries
    the kernel wrapper it calls as `step.kernel` (None for the plain
    chain)."""
    kernel = None
    if fused_model is not None:
        big = topo.nbody in LANE_BIG_BODIES
        if topo.nbody != SMPL_BODIES and not big:
            raise NotImplementedError(
                f"no control-step kernel for a {topo.nbody}-body tree (the "
                f"port has {SMPL_BODIES} and {LANE_BIG_BODIES.start}-"
                f"{LANE_BIG_BODIES.stop - 1} bodies)")
        library = model_is_batched(fused_model)
        if library:
            from uhc_tpu_torch.physics.control_step import PE_MODEL_LEAVES

            axes = model_batch_axes(fused_model)
            extra = sorted(k for k, a in axes.items()
                           if a == 0 and k not in PE_MODEL_LEAVES)
            if extra:
                raise ValueError(f"model library leaves {extra} differ per "
                                 "sequence; the per-env kernel takes "
                                 f"{PE_MODEL_LEAVES}")
        lane = os.environ.get("UHC_TPU_LANE", "1") == "1" and (
            not big or os.environ.get("UHC_TPU_LANE_BIG", "1") == "1")
        from uhc_tpu_torch.physics.control_step import lane_only

        # where the JAX package runs its XLA chain: explicit RFC or
        # per-joint meta-PD off the lane route, explicit RFC over a library
        on_xla = lane_only(cfg) and (
            not lane or (library and S.explicit_rfc(cfg)))
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
        m = env_models(model, states.seq_idx)
        prev_bquat = get_body_quat(states.qpos)
        tgt = expert_at(expert_lib, states.seq_idx,
                        states.start_ind + states.cur_t + 1)
        qpos, qvel = sim(m, states, actions,
                         tgt["qpos"][:, 7:].contiguous(), rfc_rate)
        states = dataclasses.replace(
            states, qpos=qpos, qvel=qvel, prev_qpos=states.qpos,
            cur_t=states.cur_t + 1, prev_bquat=prev_bquat)
        return env_post_step(topo, m, cfg, states, actions, expert_lib,
                             jpos_diffw, body_diffw, train)

    step.kernel = kernel
    return step


def match_heading_and_pos(qpos_1, qpos_2, base_rot):
    """Align qpos_2's heading and xy to qpos_1 (both (B, nq))."""
    base_rot = qpos_1.new_tensor(base_rot)
    heading_1 = heading_quat(quat_mul(qpos_1[:, 3:7], quat_inv(base_rot)))
    new_quat = quat_mul(heading_1, de_heading(qpos_2[:, 3:7]))
    return torch.cat([qpos_1[:, :2], qpos_2[:, 2:3], new_quat,
                      qpos_2[:, 7:]], 1)


def env_reset(topo: Topology, model: Model, cfg: EnvConfig, seq_idx,
              expert_lib, neutral_qpos, neutral_qvel, start_ind=None,
              train: bool = True, generator: torch.Generator = None):
    """reset_model for a batch of sequences `seq_idx` (B,): the expert
    window-start frame, plus (train only) joint noise and, with
    reactive_v=1, the heading-matched neutral pose with prob reactive_rate."""
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
    return EnvState(
        qpos=init_qpos, qvel=init_qvel, prev_qpos=init_qpos, cur_t=zero,
        start_ind=start_ind, seq_idx=seq_idx,
        prev_bquat=get_body_quat(init_qpos), done=false, fail=false.clone(),
        end=false.clone(), percent=init_qpos.new_zeros(B))
