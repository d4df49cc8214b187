"""Copycat training agent (PyTorch twin of uhc_tpu.learn.agent
CopycatAgent) on the 24-body stand-in humanoid, its ball-joint twin
(`env.robot_ball`: one quaternion per joint, direct torque control, obs
v2_quat; the `ball` config) or a tree built from it: the 52-body SMPL-H
(`env.robot_model == "smplh"`: every bone offset exact from 52-joint
SMPL-H model data given as `smpl_data`, `smpl.smplh.smplh_model_from_data`,
else anthropometric finger chains, `smpl.smplh.smplh_model`) or the
48-body masterfoot
(`env.masterfoot`, `smpl.masterfoot.masterfoot_model`, whose converter
remaps the 24-body clips onto the tree and gives its diff weights), each
with the enlarged feet of `env.bigfoot` (`smpl.masterfoot.bigfoot_model`,
set by a YAML whose mujoco_model names "bigfoot"). On CUDA a big tree
runs through K1d, or K1f under explicit RFC or per-joint meta-PD.

With a shape-conditioned config (`has_shape`) every clip gets its own body
from its SMPL betas (`data.dataset.build_shaped_library`): real SMPL model
data when `smpl_data` names a file, else synthetic blendshapes around the
stand-in's skeleton (`smpl.lbs.synthetic_smpl_data_like`, announced by a
loud warning). With `dr_variants >= 2` every clip is replicated over
contact- and mass-randomized models (`build_dr_library`). Either way the
agent simulates a model library (`sim_model`) and the kernels take each
env's seq_idx (K1e).

One epoch (agent_copycat.py:326 optimize_policy): the adaptive schedules,
a rollout of B humanoids × T control steps on the device (physics, obs,
reward, auto-reset), GAE, the PPO update, and the hard-mining telemetry
back to the host sampler. The exploration std follows the schedule
(`fix_std`, the release configs) or, with fix_std false, is a trained
parameter with its own Adam. The policy is the config's `actor_type`: MCP,
or else the Gaussian (`nets.make_policy`; its transformer needs a token
layout the agent does not give, as in the JAX agent). On CUDA the physics
runs through a control-step kernel (K1, or K2 under UHC_TPU_LANE=0); on
the CPU, which the caller asks for with device="cpu", through the plain
PCG-5 chain, as the JAX agent does off the TPU.

Data-parallel (`dist`, a learn/data_parallel.Dist; the JAX agent's
`mesh`, uhc_tpu/learn/agent.py:10-13,48,265-272): `num_envs` is global
and each of the W ranks holds num_envs / W envs; every model library and
tree is replicated. The running statistics, the advantages' whitening,
PPO's minibatches and gradients, the epoch stats and the sampler's
telemetry cover the global batch, and the parameters, log-std and
statistics are broadcast from rank 0 at construction and after every
checkpoint load. Rollouts draw from a generator of each rank's own, PPO's
shuffles from one seeded alike on every rank. After each epoch the ranks
compare a digest of what must stay identical (`replica_digest`) and
raise if it differs. Checkpoints keep the single-process layout; the
caller saves them on rank 0.

The reset pose for reactive initialization is the first frame of the
first clip at rest (the reference's standing_neutral.pkl is not in the
repository); on the ball family that frame is already in quaternions,
which the JAX agent makes of its euler neutral pose. Checkpoints are
pickles of numpy arrays in the JAX package's layout, so either package
loads the other's.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import pickle
import warnings
from typing import Optional

import numpy as np
import torch

from uhc_tpu_torch.config.config import Config
from uhc_tpu_torch.data import joblib_compat
from uhc_tpu_torch.data.dataset import (build_dr_library,
                                        build_expert_library,
                                        build_shaped_library,
                                        load_motion_file,
                                        neutral_from_library)
from uhc_tpu_torch.data.sampling import FailureFrequencySampler
from uhc_tpu_torch.device import resolve_device
from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.learn import nets, running_norm as RN
from uhc_tpu_torch.learn.gae import estimate_advantages
from uhc_tpu_torch.learn.ppo import ppo_update, ppo_update_dist
from uhc_tpu_torch.learn.rollout import init_env_states, make_rollout_fn
from uhc_tpu_torch.physics import control_step as CS
from uhc_tpu_torch.physics.model import model_from_numpy
from uhc_tpu_torch.smpl.constants import default_diff_weights
from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid
from uhc_tpu_torch.utils import spans


class CopycatAgent:
    def __init__(self, cfg: Config, motion_file: str, num_envs: int = 1024,
                 horizon: int = 48, seed: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 results_dir: Optional[str] = None, device=None,
                 smpl_data=None, dr_variants: int = 0,
                 dr_friction_scale: float = 1.5,
                 dr_contact_scale: float = 2.0, dr_mass_scale: float = 1.15,
                 dr_seed: int = 0, dist=None):
        self.cfg, self.env_cfg = cfg, cfg.env
        self.num_envs, self.horizon = num_envs, horizon
        self.dist = dist
        world = 1 if dist is None else dist.world_size
        if num_envs % world:
            raise ValueError(f"{num_envs} envs do not split over {world} "
                             f"ranks")
        # this rank's envs
        self.local_envs = num_envs // world
        self.device = dev = (resolve_device(device) if dist is None
                             else dist.device)
        self.results_dir = results_dir or default_results_dir(cfg)
        os.makedirs(os.path.join(self.results_dir, "models"), exist_ok=True)

        self.topo, model_np = load_fixture_humanoid()
        self.topo, model_np, self.converter, jpw, bdw = robot_family(
            self.topo, model_np, self.env_cfg, smpl_data)
        self.model = model_from_numpy(model_np, dev)
        (self.expert_lib, self.seq_keys, self.sim_model,
         self.smpl_data) = build_library(
            self.topo, self.model, self.env_cfg,
            load_motion_file(motion_file), smpl_data, dr_variants,
            dr_friction_scale, dr_contact_scale, dr_mass_scale, dr_seed,
            max_len=max_seq_len, converter=self.converter)
        nq, nv = neutral_from_library(self.expert_lib)
        self.aux = {"neutral_qpos": nq, "neutral_qvel": nv,
                    "jpos_diffw": torch.as_tensor(jpw, device=dev),
                    "body_diffw": torch.as_tensor(bdw, device=dev)}
        self.action_dim = sum(H.action_dims(self.topo, self.env_cfg))
        self.obs_dim = H.obs_dim(self.topo, self.env_cfg)

        seed = cfg.seed if seed is None else seed
        init_gen = torch.Generator().manual_seed(seed)
        self.policy = nets.make_policy(cfg, self.obs_dim, self.action_dim,
                                       init_gen, dev)
        self.value = nets.value_init(self.obs_dim, cfg.value_hsize, init_gen,
                                     cfg.value_htype, dev)
        self.log_std = torch.full((self.action_dim,), cfg.log_std,
                                  device=dev)
        self._make_optimizers()
        if dist is None:
            # every draw of rollouts and PPO shuffles, on the device
            self.gen = torch.Generator(device=dev).manual_seed(seed)
            self.ppo_gen = self.gen
        else:
            # rollouts: a stream of each rank's own; shuffles: one stream,
            # seeded alike, drawn alike on every rank
            self.gen = torch.Generator(device=dev).manual_seed(int(
                np.random.SeedSequence([seed, dist.rank]).generate_state(
                    1, np.uint64)[0] >> np.uint64(1)))
            self.ppo_gen = torch.Generator(device=dev).manual_seed(seed)

        self.rs = RN.init(self.obs_dim, dev)
        self.env_states = init_env_states(self.topo, self.env_cfg,
                                          self.sim_model, self.expert_lib,
                                          self.aux, self.gen,
                                          self.local_envs)
        self.sampler = FailureFrequencySampler(
            len(self.seq_keys), cfg.sampling_temp, cfg.sampling_freq)
        self.precision_mode = cfg.precision_mode

        self._fused_model = self.sim_model if dev.type == "cuda" else None
        self._rollout = make_rollout_fn(
            self.topo, self.env_cfg, lambda x: self.policy(x), horizon,
            fused_model=self._fused_model, dist=dist)
        self.minibatch = min(cfg.mini_batch_size, num_envs * horizon)
        self.epoch = 0
        # episode-end reward bonus from the previous epoch's average custom
        # reward (agent_copycat.py:333-334)
        self.end_reward = 0.0
        self._eval_fn = None
        # replica_digest after each epoch (data-parallel runs)
        self.replica_digests = []
        self._broadcast_state()

    def _broadcast_state(self):
        """Rank 0's parameters, log-std and running statistics on every
        rank (one flat broadcast); nothing without `dist`."""
        if self.dist is None:
            return
        tensors = [*self.policy.parameters(), *self.value.parameters(),
                   self.log_std, self.rs.n, self.rs.mean, self.rs.m2]
        with torch.no_grad():
            flat = self.dist.broadcast(torch.cat(
                [t.detach().reshape(-1) for t in tensors]))
            at = 0
            for t in tensors:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()

    def replica_digest(self) -> str:
        """SHA-256 of what every rank must hold alike: the parameters, the
        log-std, the running statistics and the sampler's state."""
        h = hashlib.sha256()
        for t in (*self.policy.parameters(), *self.value.parameters(),
                  self.log_std, self.rs.n, self.rs.mean, self.rs.m2):
            spans.count("host_sync")
            h.update(t.detach().cpu().numpy().tobytes())
        h.update(json.dumps(self.sampler.state_dict()).encode())
        return h.hexdigest()

    def _check_replicas(self):
        """Append this epoch's digest and raise if any rank's differs."""
        digest = self.replica_digest()
        spans.count("host_sync")
        words = torch.tensor(np.frombuffer(bytes.fromhex(digest), np.int64),
                             device=self.device)
        rows = self.dist.gather(words)
        spans.count("host_sync")
        if not bool((rows == rows[0]).all()):
            raise RuntimeError(f"rank {self.dist.rank}: the ranks' "
                               f"parameters, statistics or sampler diverged "
                               f"at epoch {self.epoch}")
        self.replica_digests.append(digest)

    def _make_optimizers(self):
        """Fresh Adam states for the policy and the value net and, with a
        trainable std (fix_std=False), for the log-std at the policy's
        learning rate (the reference's action_log_std is a policy
        parameter)."""
        self.policy_opt = torch.optim.Adam(self.policy.parameters(),
                                           lr=self.cfg.policy_lr)
        self.value_opt = torch.optim.Adam(self.value.parameters(),
                                          lr=self.cfg.value_lr)
        self.log_std_opt = None
        if not self.cfg.fix_std:
            self.log_std = self.log_std.detach().clone().requires_grad_()
            self.log_std_opt = torch.optim.Adam([self.log_std],
                                                lr=self.cfg.policy_lr)

    def _sync(self):
        spans.count("host_sync")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- one PPO epoch --------------------------------------------------------
    def optimize_policy(self, epoch: int) -> dict:
        """Adaptive schedules + rollout + GAE + PPO + mining telemetry
        (agent_copycat.py:326 optimize_policy / :279 per_epoch_update).
        The stats carry the epoch's span table (utils/spans.py): spans
        epoch / rollout, rollout.sync, update, tail below it, the rollout
        step's, PPO's and the collectives' further down, the counters,
        and each kernel entry's launches as count.launch.<entry>;
        T_rollout (rollout + rollout.sync), T_update and T_total read
        these spans."""
        spans.begin()
        launches = dict(CS.LAUNCHES)
        c0 = 0.0 if self.dist is None else self.dist.seconds
        with spans.span("epoch", label=epoch) as ep:
            with spans.span("rollout"):
                traj, last_obs = self._collect(epoch)
            with spans.span("rollout.sync"):
                self._sync()
            with spans.span("update"):
                ppo_stats = self._update(traj, last_obs)
                self._sync()
            with spans.span("tail"):
                stats = self._epoch_stats(traj, ppo_stats)
                if self.cfg.end_reward:
                    self.end_reward = stats["c_reward_mean"] * \
                        self.cfg.gamma / (1.0 - self.cfg.gamma)
                self.sampler.update_from_rollout(*self._telemetry(traj))
                self.epoch = epoch
                if self.dist is not None:
                    self._check_replicas()
        for key, n in CS.LAUNCHES.items():
            if n != launches.get(key, 0):
                spans.count("launch." + key[0], n - launches.get(key, 0))
        table = spans.table()
        stats.update(table)
        at = ep.path + spans.SEP
        stats["T_total"] = table[ep.path + ".s"]
        stats["T_rollout"] = (table[at + "rollout.s"]
                              + table[at + "rollout.sync.s"])
        stats["T_update"] = table[at + "update.s"]
        stats["steps"] = self.horizon * self.num_envs
        stats["steps_per_sec"] = stats["steps"] / stats["T_total"]
        stats["rollout_steps_per_sec"] = stats["steps"] / stats["T_rollout"]
        if self.dist is not None:
            stats["rank_rollout_steps_per_sec"] = (
                self.horizon * self.local_envs / stats["T_rollout"])
            stats["T_collectives"] = self.dist.seconds - c0
        return stats

    def _collect(self, epoch: int):
        """The epoch's schedules and rollout -> (traj, last_obs)."""
        cfg, dev = self.cfg, self.device
        noise_rate, log_std_sched, _lr = cfg.adaptive_params(epoch)
        if cfg.fix_std:
            self.log_std = torch.full_like(self.log_std, log_std_sched)
        rfc_rate = (max(0.0, 1.0 - epoch / 10000.0)
                    if self.env_cfg.rfc_decay else 1.0)
        # two copies from the host: on a card each waits for the stream
        spans.count("host_sync", 2)
        seq_logits = torch.as_tensor(self.sampler.logits(), device=dev)
        fail_pool = torch.as_tensor(self.sampler.fail_start_pool(),
                                    dtype=torch.int64, device=dev)
        precision_freq = cfg.sampling_freq if self.precision_mode else 0.0

        self.env_states, self.rs, traj, last_obs = self._rollout(
            self.sim_model, self.expert_lib, self.aux, self.log_std, self.rs,
            self.env_states, self.gen, noise_rate, rfc_rate, seq_logits,
            self.end_reward, fail_pool, precision_freq)
        return traj, last_obs

    def _update(self, traj, last_obs) -> dict:
        """The value pass, GAE and PPO over the epoch's rollout."""
        cfg = self.cfg
        T, B = traj.rewards.shape
        states = traj.states.reshape(T * B, self.obs_dim)
        with torch.no_grad():
            values = self.value(states).reshape(T, B)
            bootstrap = self.value(last_obs)
        adv, ret = estimate_advantages(traj.rewards, traj.masks, values,
                                       bootstrap, cfg.gamma, cfg.tau,
                                       dist=self.dist)
        batch = {"states": states,
                 "actions": traj.actions.reshape(T * B, self.action_dim),
                 "advantages": adv.reshape(-1), "returns": ret.reshape(-1),
                 "exps": traj.exps.reshape(-1)}
        if self.dist is None:
            return ppo_update(
                self.policy, self.value, self.policy_opt, self.value_opt,
                self.log_std, batch, self.gen, cfg.clip_epsilon,
                cfg.num_optim_epoch, self.minibatch,
                log_std_opt=self.log_std_opt)
        return ppo_update_dist(
            self.policy, self.value, self.policy_opt, self.value_opt,
            self.log_std, batch, self.ppo_gen, cfg.clip_epsilon,
            cfg.num_optim_epoch, self.minibatch, self.dist, B,
            log_std_opt=self.log_std_opt)

    def _epoch_stats(self, traj, ppo_stats) -> dict:
        """The epoch's sums over every rank's envs, as host numbers."""
        T = traj.rewards.shape[0]
        done_f = traj.dones.to(torch.float32)
        K = traj.reward_terms.shape[-1]
        sums = torch.cat([torch.stack([
            traj.rewards.sum(), traj.c_rewards.sum(), done_f.sum(),
            (traj.percents * done_f).sum(),
            # 1-ulp tolerance, as in learn/metrics.py succ
            ((traj.percents >= 1.0 - 1e-5) * done_f).sum()]).to(
                torch.float32),
            traj.reward_terms.sum((0, 1)).to(torch.float32)])
        if self.dist is not None:
            self.dist.all_reduce(sums)
        n_steps = T * self.num_envs
        n_done = torch.clamp(sums[2], min=1.0)
        scalars = {
            "reward_mean": sums[0] / n_steps,
            "c_reward_mean": sums[1] / n_steps,
            "episodes": sums[2],
            "avg_percent": sums[3] / n_done,
            "success_rate": sums[4] / n_done,
            "avg_eps_len": self.horizon * self.num_envs / n_done,
            **ppo_stats}
        spans.count("host_sync", 2)
        stats = dict(zip(scalars, torch.stack(
            [torch.as_tensor(v, dtype=torch.float32, device=self.device)
             for v in scalars.values()]).tolist()))
        stats["reward_terms"] = (sums[5:5 + K] / n_steps).tolist()
        return stats

    def _telemetry(self, traj):
        """The sampler's (T, B) arrays seq_idx, dones, percents,
        start_inds; under `dist` every rank's envs side by side in rank
        order, as one process holding them all would see them (one
        gather, in float64, which holds each value exactly)."""
        parts = (traj.seq_idx, traj.dones, traj.percents, traj.start_inds)
        if self.dist is None:
            spans.count("host_sync", len(parts))
            return [x.cpu().numpy() for x in parts]
        T, B = traj.dones.shape
        rows = self.dist.gather(torch.stack(
            [x.to(torch.float64) for x in parts]))      # (W, 4, T, B)
        spans.count("host_sync")
        rows = rows.permute(1, 2, 0, 3).reshape(4, T, -1).cpu().numpy()
        return [rows[0].astype(np.int64), rows[1].astype(bool),
                rows[2].astype(np.float32), rows[3].astype(np.int64)]

    # -- evaluation during training (agent_copycat.py:346-349) ----------------
    def eval_policy(self, track_best: bool = True) -> dict:
        """Deterministic eval over the whole library; returns the
        summarize() dict and keeps iter_best.p for the best coverage
        (agent_copycat.py:216-236)."""
        from uhc_tpu_torch.learn.evaluate import make_eval_fn, summarize

        if self._eval_fn is None:
            max_steps = int(self.expert_lib["len"].max()) - 1
            self._eval_fn = make_eval_fn(
                self.topo, self.env_cfg, lambda x: self.policy(x), max_steps,
                fused_model=self._fused_model)
        traj, fail_safe, percent = self._eval_fn(
            self.sim_model, self.expert_lib, self.aux, self.rs)
        res = summarize(traj, fail_safe, percent, self.expert_lib,
                        self.seq_keys, smpl_data=self.smpl_data,
                        root_offset=root_offsets(self.sim_model))
        cov = res["summary"]["coverage"]
        if not track_best:
            return res
        if not hasattr(self, "_best_coverage"):
            # a fresh run must not clobber a better iter_best.p
            self._best_coverage = self._read_best_coverage()
        if cov > self._best_coverage or (cov == self._best_coverage
                                         and self._owns_best):
            self._best_coverage = cov
            self._owns_best = True
            self.save_checkpoint(self.epoch, name="iter_best.p",
                                 extra={"coverage": cov})
        return res

    _owns_best = False

    def _read_best_coverage(self):
        path = os.path.join(self.results_dir, "models", "iter_best.p")
        if not os.path.exists(path):
            return -1
        cov = joblib_compat.load(path).get("coverage")
        if cov is not None:
            return cov
        # an iter_best.p without a coverage key: the best of the eval
        # history
        best = 0
        for fn in glob.glob(os.path.join(self.results_dir, "eval_*.json")):
            with open(fn) as f:
                best = max(best, json.load(f).get("coverage", 0))
        return best

    # -- checkpointing (pickle, like the reference iter_%04d.p) ---------------
    def checkpoint_path(self, epoch: int) -> str:
        return checkpoint_path(self.results_dir, epoch)

    def save_checkpoint(self, epoch: int, name: str | None = None,
                        extra: dict | None = None):
        state = {
            "policy_params": nets.policy_to_numpy(self.policy),
            "value_params": nets.value_to_numpy(self.value),
            "log_std": self.log_std.detach().cpu().numpy(),
            "running_stats": RN.to_numpy(self.rs),
            "sampler": self.sampler.state_dict(),
            "epoch": epoch,
            **(extra or {}),
        }
        path = (os.path.join(self.results_dir, "models", name)
                if name else self.checkpoint_path(epoch))
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return path

    def load_checkpoint(self, epoch: int):
        self.load_checkpoint_file(self.checkpoint_path(epoch))

    def load_checkpoint_file(self, path: str, warm_start: bool = False):
        """Restore networks, log-std and running stats from a checkpoint of
        either package (fresh optimizer states, the log-std's too).
        warm_start=True leaves the epoch counter and the sampler fresh
        (cross-run warm start)."""
        state = joblib_compat.load(path)
        dev = self.device
        self.log_std = torch.as_tensor(np.asarray(state["log_std"],
                                                  np.float32), device=dev)
        self.policy = nets.policy_from_numpy(state["policy_params"],
                                             self.cfg.policy_htype, dev)
        self.value = nets.value_from_numpy(state["value_params"],
                                           self.cfg.value_htype, dev)
        self._make_optimizers()
        self.rs = RN.from_numpy(state["running_stats"], dev)
        self._broadcast_state()
        if warm_start:
            return
        self.sampler.load_state_dict(state["sampler"])
        self.epoch = state["epoch"]


def default_results_dir(cfg: Config) -> str:
    """Where a config's run keeps its outputs unless told otherwise."""
    return os.path.join("results", cfg.cfg_id + "_torch")


def checkpoint_path(results_dir: str, epoch: int) -> str:
    """The checkpoint of `epoch` in a results directory of either
    package: models/iter_NNNN.p."""
    return os.path.join(results_dir, "models", f"iter_{epoch:04d}.p")


def robot_family(topo, model, env_cfg, smpl_data=None):
    """The tree the config trains on, from the 24-body humanoid ->
    (topo, model with numpy leaves, converter or None, jpos_diffw,
    body_diffw), as uhc_tpu/learn/agent.py:59-106,171-191 builds it: ball
    joints on the same tree for `robot_ball`; SMPL-H for robot_model
    "smplh", its bone offsets from `smpl_data` where that is 52-joint
    SMPL-H model data (`smplh_data`), else anthropometric; then the
    enlarged feet of `bigfoot` (the same tree), then masterfoot's sole
    bodies when `masterfoot` is set (its converter remaps 24-body clips
    onto the tree and gives the diff weights)."""
    import dataclasses

    converter = None
    if env_cfg.robot_ball:
        topo = dataclasses.replace(topo, joint_kind="ball")
    if env_cfg.robot_model == "smplh":
        from uhc_tpu_torch.smpl.smplh import (smplh_diff_weights,
                                              smplh_model,
                                              smplh_model_from_data,
                                              smplh_topology)

        data = smplh_data(smpl_data)
        model = (smplh_model(topo, model) if data is None
                 else smplh_model_from_data(topo, model, data))
        topo = smplh_topology()
        jpw, bdw = smplh_diff_weights()
    else:
        jpw, bdw = default_diff_weights()
    if env_cfg.bigfoot:
        from uhc_tpu_torch.smpl.masterfoot import bigfoot_model

        model = bigfoot_model(topo, model)
    if env_cfg.masterfoot:
        from uhc_tpu_torch.smpl.masterfoot import masterfoot_model

        topo, model, converter = masterfoot_model(topo, model,
                                                  env_cfg.master_range)
        jpw = converter.get_new_diff_weight().astype(np.float32)
        bdw = jpw[1:]
    return topo, model, converter, jpw, bdw


def build_library(topo, model, env_cfg, seqs, smpl_data=None,
                  dr_variants: int = 0, dr_friction_scale: float = 1.5,
                  dr_contact_scale: float = 2.0, dr_mass_scale: float = 1.15,
                  dr_seed: int = 0, max_len=None, converter=None):
    """The expert library and the model it simulates -> (expert_lib, keys,
    sim_model, smpl_data): a shaped library for a shape-conditioned
    config, a domain-randomized one for dr_variants >= 2, else the shared
    model (with a converter, the clips go through the 24-body layout onto
    the converter's tree). smpl_data (one SMPLData, the neutral one of a
    gendered set) is what the eval's vertex metrics use: 24-joint data on
    the 24-body tree, 52-joint SMPL-H data on SMPL-H (`smplh_data`), None
    without model data or on another tree."""
    if topo.nbody != 24 and (env_cfg.has_shape or dr_variants >= 2):
        # the JAX agent refuses dr_variants on these trees
        # (uhc_tpu/learn/agent.py:142-144); its shape library is built
        # for the 24-body tree alone
        raise NotImplementedError(
            "model libraries are supported on the 24-body SMPL family")
    if env_cfg.has_shape:
        shape_data = load_shape_data(topo, model, smpl_data)
        lib, keys, sim_model = build_shaped_library(
            topo, model, seqs, shape_data, env_cfg, max_len=max_len)
        return lib, keys, sim_model, neutral_data(shape_data)
    if dr_variants >= 2:
        lib, keys, sim_model = build_dr_library(
            topo, model, seqs, dr_variants, dr_friction_scale,
            dr_contact_scale, dr_mass_scale, dr_seed, max_len=max_len)
    else:
        lib, keys = build_expert_library(
            topo, model, seqs, max_len=max_len, converter=converter,
            base_root_offset=(None if converter is None
                              else model.body_pos[0].cpu().numpy()))
        sim_model = model
    if topo.nbody == 52:
        smpl_data = smplh_data(smpl_data)
    elif smpl_data is not None:
        smpl_data = (neutral_data(load_shape_data(topo, model, smpl_data))
                     if topo.nbody == 24 else None)
    return lib, keys, sim_model, smpl_data


def smplh_data(smpl_data):
    """52-joint SMPL-H model data from `smpl_data`: a path that
    `load_smplh_data` reads as 52 joints, or SMPLData of 52 joints; None
    for anything else, a file it refuses (ValueError, KeyError) included,
    as the JAX agent falls back (uhc_tpu/learn/agent.py:69-91)."""
    from uhc_tpu_torch.smpl.lbs import SMPLData, load_smplh_data

    if isinstance(smpl_data, str):
        try:
            smpl_data = load_smplh_data(smpl_data)
        except (ValueError, KeyError):
            return None
    if isinstance(smpl_data, SMPLData) and \
            smpl_data.j_regressor.shape[0] == 52:
        return smpl_data
    return None


def load_shape_data(topo, model, smpl_data=None):
    """SMPL model data for shape training: a path (.pkl / .npz) is loaded,
    SMPLData or a dict of them by gender is used as it is, and None falls
    back, loudly, to synthetic blendshapes around `model`'s skeleton."""
    from uhc_tpu_torch.smpl.lbs import (load_smpl_data,
                                        synthetic_smpl_data_like)

    if smpl_data is None:
        warnings.warn(
            "shape training without SMPL model data: falling back to "
            "synthetic_smpl_data_like() (synthetic blendshapes around the "
            "stand-in skeleton, NOT real SMPL bodies). Pass smpl_data=<path "
            "to SMPL pkl/npz> for real shapes.", stacklevel=3)
        print("[uhc_tpu_torch] WARNING: shape training is using SYNTHETIC "
              "SMPL blendshapes (no smpl_data provided).", flush=True)
        return synthetic_smpl_data_like(topo, model)
    if isinstance(smpl_data, str):
        return load_smpl_data(smpl_data)
    return smpl_data


def neutral_data(smpl_data):
    """One SMPLData: the neutral one of a dict by gender."""
    if isinstance(smpl_data, dict):
        return smpl_data.get("neutral", next(iter(smpl_data.values())))
    return smpl_data


def root_offsets(model):
    """The Pelvis zero-pose offset: (3,) for a shared model, (S, 3) for a
    library whose body_pos differs per sequence."""
    bp = model.body_pos.cpu().numpy()
    return bp[:, 0] if bp.ndim == 3 else bp[0]
