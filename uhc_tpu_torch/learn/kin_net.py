"""Autoregressive kinematic network (PyTorch twin of uhc_tpu.learn.kin_net,
reference uhc/models/kin_net.py), batched over sequences.

KinNet predicts a kinematic action per frame (80 = 74 qpos-style dims + 6
root velocities) from an obs_v1-style comparison of its own integrated
state against the next GT frame; `step_ar`, the kin env's own rule,
integrates it, so a trained net drives the hierarchical env directly.
`model_v` 1 (and 0) is a GRU then an MLP over [state, h], 2 the MLP alone.

The rollout is a Python loop over time with the GRU state and the
integrator (qpos, qvel) carried; scheduled sampling enters as a mask
given by the caller (one draw a frame), as in the JAX package. KinPolicy
(uhc/models/kin_policy.py) is the same module with a log-std beside the
mean.

Weights use the checkpoint's layout (`action_rnn` {w_ih, w_hh, b_ih,
b_hh}, `action_mlp` [{w, b}, ...], `action_fc` {w, b}, `log_std`):
`kin_net_from_numpy` / `kin_net_to_numpy` carry them across both ways.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from uhc_tpu_torch.envs.expert import qpos_fk_frame
from uhc_tpu_torch.envs.humanoid_kin import (KIN_QPOS_LM, KinConfig,
                                             ar_obs_from, step_ar)
from uhc_tpu_torch.learn import losses as L
from uhc_tpu_torch.learn.nets import (GRU, MLP, _affine, _init_trunks,
                                      _load_trunk, _set, _uniform,
                                      gru_from_numpy, gru_init, gru_to_numpy)
from uhc_tpu_torch.maths import (de_heading, heading_angle, heading_quat,
                                 quat_inv, quat_mul, qvel_fd, transform_vec,
                                 wrap_to_pi)
from uhc_tpu_torch.physics.model import Model, Topology


@dataclasses.dataclass(frozen=True)
class KinNetSpecs:
    """The model_specs KinNet reads (kin_net.py:75-80)."""

    mlp_htype: str = "relu"
    mlp_hsize: Tuple[int, ...] = (1024, 512)
    rnn_hdim: int = 512
    model_v: int = 1          # 1 (and 0): GRU + MLP; 2: MLP only
    pose_delta: bool = False
    remove_base: bool = False
    base_rot: Tuple[float, ...] = (0.7071, 0.7071, 0.0, 0.0)
    log_std: float = -2.3     # KinPolicy's fixed-std head
    # env_obs: supervised rollouts observe through the env's own feature
    # function (humanoid_kin.ar_obs_from) against the NEXT GT frame, the
    # layout the net sees in RL and eval; False keeps the reference
    # KinNet.get_obs conventions (current-frame target, body-major jpos)
    env_obs: bool = False


def kin_obs_dim(topo: Topology, obs_vel: str = "full") -> int:
    nb, nq, nv = topo.nbody, topo.nq, topo.nv
    vel = nv if obs_vel == "full" else 6
    return 4 + 3 * (nq - 2) + vel + 3 + 3 * nb * 2 + 4 * nb * 2


def kin_action_dim() -> int:
    return KIN_QPOS_LM + 6


class KinNet(nn.Module):
    """GRU (model_v 0, 1) + MLP + action head, and the policy's log-std."""

    def __init__(self, state_dim: int, specs: KinNetSpecs):
        super().__init__()
        self.specs = specs
        self.recurrent = specs.model_v in (0, 1)
        self.action_rnn = (GRU(state_dim, specs.rnn_hdim) if self.recurrent
                           else None)
        mlp_in = state_dim + (specs.rnn_hdim if self.recurrent else 0)
        self.action_mlp = MLP(mlp_in, specs.mlp_hsize, specs.mlp_htype)
        self.action_fc = _affine(specs.mlp_hsize[-1], kin_action_dim())
        self.log_std = nn.Parameter(torch.full((kin_action_dim(),),
                                               float(specs.log_std)))

    def forward(self, state, h):
        """(B, state_dim), (B, H) -> (action (B, 80), h') (kin_net.py:
        443-453): h advances through the GRU, the MLP reads [state, h']."""
        if self.recurrent:
            h = self.action_rnn(state, h)
            x = torch.cat([state, h], -1)
        else:
            x = state
        x = self.action_mlp(x)
        return x @ self.action_fc["w"] + self.action_fc["b"], h


def kin_net_init(topo: Topology, specs: KinNetSpecs,
                 generator: torch.Generator, device="cuda") -> KinNet:
    """Seeded random KinNet (uhc_tpu.learn.kin_net kin_net_init): the GRU
    U(±1/√H), every affine layer U(±1/√fan_in), log_std at specs.log_std."""
    m = KinNet(kin_obs_dim(topo), specs)
    with torch.no_grad():
        if m.recurrent:
            m.action_rnn = gru_init(kin_obs_dim(topo), specs.rnn_hdim,
                                    generator, "cpu")
        _init_trunks(generator, m.action_mlp)
        lim = 1.0 / np.sqrt(specs.mlp_hsize[-1])
        for k in ("w", "b"):
            p = m.action_fc[k]
            p.copy_(_uniform(p.shape, lim, generator))
    return m.to(device)


def kin_net_from_numpy(params, specs: KinNetSpecs, device="cuda") -> KinNet:
    """A checkpoint's "params" tree -> KinNet on `device`; the state width
    comes from the tree."""
    mlp = params["action_mlp"]
    in_dim = np.shape(mlp[0]["w"])[0]
    if "action_rnn" in params:
        state_dim = np.shape(params["action_rnn"]["w_ih"])[0]
        if in_dim != state_dim + specs.rnn_hdim:
            raise ValueError(f"action_mlp input {in_dim} is not state "
                             f"{state_dim} + rnn_hdim {specs.rnn_hdim}")
    else:
        state_dim = in_dim
    specs = dataclasses.replace(
        specs, mlp_hsize=tuple(np.shape(t["w"])[1] for t in mlp))
    m = KinNet(state_dim, specs)
    if m.recurrent != ("action_rnn" in params):
        raise ValueError(f"model_v {specs.model_v} does not match the "
                         "checkpoint's layers")
    if m.recurrent:
        m.action_rnn = gru_from_numpy(params["action_rnn"], "cpu")
    _load_trunk(m.action_mlp, mlp)
    _set(m.action_fc["w"], params["action_fc"]["w"])
    _set(m.action_fc["b"], params["action_fc"]["b"])
    if "log_std" in params:
        _set(m.log_std, params["log_std"])
    return m.to(device)


def kin_net_to_numpy(m: KinNet) -> dict:
    """KinNet -> the checkpoint's "params" tree (numpy)."""
    def arr(p):
        return p.detach().cpu().numpy().copy()

    out = {}
    if m.recurrent:
        out["action_rnn"] = gru_to_numpy(m.action_rnn)
    out["action_mlp"] = [{"w": arr(w), "b": arr(b)}
                         for w, b in zip(m.action_mlp.ws, m.action_mlp.bs)]
    out["action_fc"] = {"w": arr(m.action_fc["w"]),
                        "b": arr(m.action_fc["b"])}
    out["log_std"] = arr(m.log_std)
    return out


def kin_net_obs(topo: Topology, model: Model, specs: KinNetSpecs, qpos, qvel,
                gt_qpos, obs_vel: str = "full"):
    """Per-frame observation of the reference KinNet.get_obs
    (kin_net.py:285-405): the integrator state (B, nq), (B, nv) against
    the GT frame (B, nq); body-major jpos blocks relative to the root
    body, the reference's double linear-velocity transform."""
    B = qpos.shape[0]
    base_rot = qpos.new_tensor(specs.base_rot)
    curr_root_quat = quat_mul(qpos[:, 3:7], quat_inv(base_rot))
    hq = heading_quat(curr_root_quat)
    target_qpos = gt_qpos
    target_root_quat = quat_mul(target_qpos[:, 3:7], quat_inv(base_rot))
    qpos_dh = torch.cat([qpos[:, :3], de_heading(curr_root_quat),
                         qpos[:, 7:]], 1)
    diff_qpos = torch.cat([
        target_qpos[:, :2], target_qpos[:, 2:3] - qpos_dh[:, 2:3],
        quat_mul(target_root_quat, quat_inv(curr_root_quat)),
        target_qpos[:, 7:] - qpos_dh[:, 7:]], 1)
    obs = [hq, target_qpos[:, 2:], qpos_dh[:, 2:], diff_qpos[:, 2:]]
    v = transform_vec(qvel[:, :3], qpos_dh[:, 3:7], "root")
    v = transform_vec(v, curr_root_quat, "root")
    qvel_o = torch.cat([v, qvel[:, 3:]], 1)
    obs.append(qvel_o if obs_vel == "full" else qvel_o[:, :6])
    obs.append(wrap_to_pi(heading_angle(target_root_quat)
                          - heading_angle(curr_root_quat))[:, None])
    # target_root_quat[:3] read kept (kin_net.py:340)
    rel_pos = transform_vec(target_root_quat[:, :3] - qpos_dh[:, :3],
                            curr_root_quat, "root")
    obs.append(rel_pos[:, :2])
    pred_fk = qpos_fk_frame(topo, model, qpos)
    tgt_fk = qpos_fk_frame(topo, model, target_qpos)
    pred_jpos = pred_fk["wbpos"].reshape(B, -1, 3)
    crq = curr_root_quat[:, None]
    obs.append(transform_vec(pred_jpos - pred_jpos[:, 0:1], crq,
                             "root").reshape(B, -1))
    obs.append(transform_vec(tgt_fk["wbpos"].reshape(B, -1, 3) - pred_jpos,
                             crq, "root").reshape(B, -1))
    pred_wbquat = pred_fk["wbquat"].reshape(B, -1, 4)
    tgt_wbquat = tgt_fk["wbquat"].reshape(B, -1, 4)
    obs.append(quat_mul(quat_inv(hq)[:, None], pred_wbquat).reshape(B, -1))
    obs.append(quat_mul(quat_inv(pred_wbquat), tgt_wbquat).reshape(B, -1))
    return torch.cat(obs, 1)


def kin_net_action(net: KinNet, state, h):
    """(B, state_dim), (B, H) -> (action, h') (kin_net.py:443-453)."""
    return net(state, h)


def kin_net_step(specs: KinNetSpecs, qpos, qvel, action, dt=1.0 / 30.0):
    """Integrate actions: step_ar and the finite-difference qvel
    (kin_net.py:407-441)."""
    kc = KinConfig(pose_delta=specs.pose_delta, remove_base=specs.remove_base,
                   base_rot=specs.base_rot)
    next_qpos = step_ar(kc, qpos, action, dt)
    return next_qpos, qvel_fd(qpos, next_qpos, dt)


def kin_net_rollout(net: KinNet, topo: Topology, model: Model,
                    specs: KinNetSpecs, gt_qpos_seq, gt_qvel_seq,
                    ss_mask=None) -> dict:
    """Autoregressive forward over N sequences at once (kin_net.py:176-232):
    gt_qpos_seq (N, T, nq), gt_qvel_seq (N, T, nv), ss_mask (N, T) bool,
    frames where scheduled sampling resets the integrator to GT (None: no
    reset). Returns {qpos (N, T, nq), qvel (N, T, nv), wbpos
    (N, T, 3·nb), action (N, T - 1, 80)}."""
    N, T = gt_qpos_seq.shape[:2]
    if ss_mask is None:
        ss_mask = torch.zeros((N, T), dtype=torch.bool,
                              device=gt_qpos_seq.device)
    h = gt_qpos_seq.new_zeros((N, specs.rnn_hdim))
    qpos, qvel = gt_qpos_seq[:, 0], gt_qvel_seq[:, 0]
    if specs.env_obs:
        from uhc_tpu_torch.config.config import EnvConfig

        cc_cfg = EnvConfig(base_rot=specs.base_rot)
    qposs, qvels, actions = [qpos], [qvel], []
    for t in range(T - 1):
        if specs.env_obs:
            # the env's layout against the NEXT frame: what get_ar_obs_v1
            # feeds the net in the hierarchical rollout
            state = ar_obs_from(topo, model, cc_cfg, qpos, qvel,
                                gt_qpos_seq[:, t + 1])
        else:
            state = kin_net_obs(topo, model, specs, qpos, qvel,
                                gt_qpos_seq[:, t])
        action, h = net(state, h)
        nqpos, nqvel = kin_net_step(specs, qpos, qvel, action)
        use_gt = ss_mask[:, t + 1, None]
        qpos = torch.where(use_gt, gt_qpos_seq[:, t + 1], nqpos)
        qvel = torch.where(use_gt, gt_qvel_seq[:, t + 1], nqvel)
        qposs.append(qpos)
        qvels.append(qvel)
        actions.append(action)
    pred_qpos = torch.stack(qposs, 1)
    wb = qpos_fk_frame(topo, model, pred_qpos.reshape(N * T, -1))["wbpos"]
    return {"qpos": pred_qpos, "qvel": torch.stack(qvels, 1),
            "wbpos": wb.reshape(N, T, -1), "action": torch.stack(actions, 1)}


LOSS_TERMS = ("r_pos_loss", "r_rot_loss", "p_rot_loss", "vl_loss",
              "va_loss", "ee_loss")


def kin_net_loss(pred: dict, gt_qpos, gt_qvel, gt_wbpos,
                 weights: Dict[str, float]):
    """Supervised sequence loss (kin_net.py:735-779 compute_loss_seq) of
    each of N sequences: the weighted sum of the six terms, each a mean
    over frames, with the reference's one-step-ahead qvel alignment ->
    (total (N,), {term: (N,)})."""
    N, T = gt_qpos.shape[:2]
    pq, pv = pred["qpos"], pred["qvel"]
    terms = {
        "r_pos_loss": L.root_pos_loss(gt_qpos, pq).mean(1),
        "r_rot_loss": L.root_orientation_loss(gt_qpos, pq).mean(1),
        "p_rot_loss": L.pose_rot_loss(gt_qpos, pq).mean(1),
        "vl_loss": L.linear_velocity_loss(gt_qvel[:, 1:],
                                          pv[:, :-1]).mean(1),
        "va_loss": L.angular_velocity_loss(gt_qvel[:, 1:],
                                           pv[:, :-1]).mean(1),
        "ee_loss": L.end_effector_pos_loss(
            gt_wbpos.reshape(N * T, -1),
            pred["wbpos"].reshape(N * T, -1)).reshape(N, T).mean(1),
    }
    total = sum(weights.get(k, 0.0) * v for k, v in terms.items())
    return total, terms


def kin_policy_mean(net: KinNet, state, h):
    """KinPolicy's mean path; h is threaded by the caller
    (uhc/models/kin_policy.py:32)."""
    return net(state, h)


# -- SuperNet (uhc/models/super_net.py:64) -----------------------------------


def super_net_specs(ms: Dict) -> KinNetSpecs:
    """SuperNet: the MLP-only (model_v 2) variant with pose_delta and
    remove_base on (super_net.py:80-82)."""
    return KinNetSpecs(mlp_htype=ms.get("mlp_htype", "relu"),
                       mlp_hsize=tuple(ms.get("mlp_hsize", (1024, 512))),
                       model_v=2, pose_delta=True, remove_base=True)


class SuperNet(nn.Module):
    """MLP + an 80-wide action head (the JAX package's head on the
    reference's raw MLP features, super_net.py:116)."""

    def __init__(self, state_dim: int, specs: KinNetSpecs):
        super().__init__()
        self.model_mlp = MLP(state_dim, specs.mlp_hsize, specs.mlp_htype)
        self.head = _affine(specs.mlp_hsize[-1], kin_action_dim())

    def forward(self, state):
        return self.model_mlp(state) @ self.head["w"] + self.head["b"]


def super_net_init(state_dim: int, specs: KinNetSpecs,
                   generator: torch.Generator, device="cuda") -> SuperNet:
    m = SuperNet(state_dim, specs)
    with torch.no_grad():
        _init_trunks(generator, m.model_mlp)
        lim = 1.0 / np.sqrt(specs.mlp_hsize[-1])
        for k in ("w", "b"):
            m.head[k].copy_(_uniform(m.head[k].shape, lim, generator))
    return m.to(device)


def super_net_from_numpy(params, specs: KinNetSpecs,
                         device="cuda") -> SuperNet:
    mlp = params["model_mlp"]
    m = SuperNet(np.shape(mlp[0]["w"])[0], dataclasses.replace(
        specs, mlp_hsize=tuple(np.shape(t["w"])[1] for t in mlp)))
    _load_trunk(m.model_mlp, mlp)
    for k in ("w", "b"):
        _set(m.head[k], params["head"][k])
    return m.to(device)


def super_net_apply(net: SuperNet, state):
    return net(state)
