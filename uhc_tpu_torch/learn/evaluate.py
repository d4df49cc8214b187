"""Policy evaluation on the device (PyTorch twin of uhc_tpu.learn.evaluate).

All test sequences advance lock-step through one batched env step, with a
Python loop over time in place of `lax.scan`. On failure mid-clip the
state is teleported back onto the expert and the sequence is marked
unsuccessful (the reference's fail-safe). The collected trajectories feed
`compute_metrics` on the host. The model is shared or a per-sequence
library; sequence s runs on row s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from uhc_tpu_torch.config.config import EnvConfig
from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.learn import running_norm as RN
from uhc_tpu_torch.learn.metrics import (compute_metrics,
                                         compute_penetration_skate_vertices,
                                         vertices_from_qpos)
from uhc_tpu_torch.physics import engine as E
from uhc_tpu_torch.physics.model import Model, Topology, env_models


def make_eval_fn(topo: Topology, cfg: EnvConfig, policy_mean_fn,
                 max_steps: int, clip_obs: float = 5.0,
                 fused_model: Model = None, per_seq_params: bool = False):
    """Returns eval_all(model, expert_lib, aux, rs) -> (traj, fail_safe,
    percent), `traj` holding (S, T, ...) pred_qpos / pred_jpos / active.
    `policy_mean_fn(normalized_obs) -> actions`. With `fused_model` the
    physics runs through the control-step kernel.

    per_seq_params (the per-sequence fit protocol): sequence s runs under
    its own policy and its own running statistics. `rs` then holds one
    row per sequence (`running_norm.stack`) and `policy_mean_fn` maps row
    s of the (S, D) batch through policy s in one forward
    (`nets.stack_policies`)."""
    if cfg.t_max >= max_steps and cfg.env_episode_len >= max_steps:
        eval_cfg = cfg
    else:
        eval_cfg = dataclasses.replace(cfg, t_max=10 ** 9,
                                       env_episode_len=10 ** 9)
    env_step_batched = H.make_env_step_batched(topo, eval_cfg,
                                               fused_model=fused_model)

    @torch.no_grad()
    def eval_all(model, expert_lib, aux, rs):
        S = expert_lib["len"].shape[0]
        dev = expert_lib["len"].device
        seq_idx = torch.arange(S, device=dev)
        models = env_models(model, seq_idx)
        lengths = expert_lib["len"]
        if per_seq_params and tuple(rs.mean.shape[:-1]) != (S,):
            raise ValueError(f"per-sequence statistics of shape "
                             f"{tuple(rs.mean.shape)} for {S} sequences")
        states = H.env_reset(topo, model, eval_cfg, seq_idx, expert_lib,
                             aux["neutral_qpos"], aux["neutral_qvel"],
                             start_ind=0, train=False)
        fail_safe = torch.zeros(S, dtype=torch.bool, device=dev)
        pred_qpos, pred_jpos, actives = [], [], []
        for t in range(max_steps):
            active = t < (lengths - 1)
            obs = H.get_obs(topo, model, eval_cfg, states,
                                    expert_lib)
            actions = policy_mean_fn(RN.normalize(rs, obs, clip_obs))
            states2, _, _, _, _ = env_step_batched(
                model, states, actions, expert_lib, aux["jpos_diffw"],
                aux["body_diffw"], train=False)
            exp = H.expert_at(expert_lib, seq_idx, states2.cur_t)
            tele = states2.fail & active
            states2 = dataclasses.replace(
                states2,
                qpos=torch.where(tele[:, None], exp["qpos"], states2.qpos),
                qvel=torch.where(tele[:, None], exp["qvel"], states2.qvel),
                done=torch.zeros_like(states2.done),
                fail=torch.zeros_like(states2.fail))
            fail_safe = fail_safe | tele
            # only advance while the clip is active
            states = H.state_where(active, states2, states)
            kin = E.fk(topo, models, states.qpos)
            pred_qpos.append(states.qpos)
            pred_jpos.append(kin["xpos"].reshape(S, -1))
            actives.append(active)
        traj = {"pred_qpos": torch.stack(pred_qpos, 1),
                "pred_jpos": torch.stack(pred_jpos, 1),
                "active": torch.stack(actives, 1)}
        return traj, fail_safe, states.percent

    return eval_all


def summarize(traj, fail_safe, percent, expert_lib, seq_keys,
              smpl_data=None, root_offset=None) -> Dict:
    """Host-side per-sequence compute_metrics + the coverage aggregate.

    With `smpl_data` and `root_offset` (the Pelvis zero-pose offset, (3,)
    or per sequence (S, 3) for a shaped library), each sequence also gets
    vertex penetration and skate from the LBS mesh of its predicted poses,
    with the library's betas where it has them (zeros otherwise)."""
    traj = {k: v.cpu().numpy() for k, v in traj.items()}
    fail_safe = fail_safe.cpu().numpy()
    percent = percent.cpu().numpy()
    lens = expert_lib["len"].cpu().numpy()
    gt_qpos = expert_lib["qpos"].cpu().numpy()
    gt_jpos = expert_lib["wbpos"].cpu().numpy()
    results, agg = {}, {}
    for s, key in enumerate(seq_keys):
        T = int(lens[s]) - 1
        m = compute_metrics(traj["pred_qpos"][s][:T], gt_qpos[s][1:T + 1],
                            traj["pred_jpos"][s][:T], gt_jpos[s][1:T + 1],
                            bool(fail_safe[s]), float(percent[s]))
        if smpl_data is not None and root_offset is not None:
            beta = (expert_lib["beta"][s].cpu().numpy()
                    if "beta" in expert_lib else np.zeros(16, np.float32))
            ro = np.asarray(root_offset)
            verts = vertices_from_qpos(traj["pred_qpos"][s][:T], smpl_data,
                                       beta, ro[s] if ro.ndim == 2 else ro)
            m.update(compute_penetration_skate_vertices(verts))
        results[key] = m
        for k, v in m.items():
            agg.setdefault(k, []).append(v)
    summary = {k: float(np.mean(v)) for k, v in agg.items()}
    summary["coverage"] = int(sum(m["succ"] for m in results.values()))
    summary["num_seqs"] = len(seq_keys)
    return {"per_seq": results, "summary": summary}
