"""Kinematic-policy trainer (PyTorch twin of uhc_tpu.learn.agent_uhm
UHMAgent, reference uhc/agents/agent_uhm.py).

A KinNet kinematic policy trains through the hierarchical env
(`envs.humanoid_kin`): each control step integrates its action into a
target pose, a frozen copycat controller drives the simulated body toward
it on the exact chain, and the UHM reward scores the result. An epoch
(`optimize_policy`, agent_uhm.py:543) mixes:
  * rl_update: PPO on the kin policy. The policy is recurrent, so the
    log-probs come from re-running the GRU over the whole rollout, its
    state reset at every episode end; `num_optim_epoch` full-batch epochs,
    the value net first, then the policy with its gradient clipped to a
    global norm of 40;
  * full_update: supervised autoregressive training on GT windows with
    scheduled sampling (KinNet.train_full_supervised), the gradient
    through the FK of every step clipped likewise; gt_rate decays
    linearly after num_epoch_fix epochs.
The kin net, its log-std and the value net train with Adam (optax's
update: every parameter steps every time, a zero gradient where one does
not enter the loss). Every draw comes from one torch.Generator.

The body is the port's stand-in humanoid (`smpl/fixture_humanoid.py`; the
JAX agent reads the reference's MJCF). Without a copycat checkpoint the
frozen controller is a seeded MCP policy, as in JAX. Checkpoints are
pickles of numpy arrays in the JAX package's layout ({"params",
"value_params", "epoch"}), so either package loads the other's.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, Optional

import torch

from uhc_tpu_torch.config.config import Config
from uhc_tpu_torch.data import joblib_compat
from uhc_tpu_torch.data.dataset import build_expert_library, load_motion_file
from uhc_tpu_torch.device import resolve_device
from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.envs import humanoid_kin as K
from uhc_tpu_torch.learn import kin_net as KN
from uhc_tpu_torch.learn import nets
from uhc_tpu_torch.learn import running_norm as RN
from uhc_tpu_torch.learn.gae import estimate_advantages
from uhc_tpu_torch.physics.model import model_from_numpy
from uhc_tpu_torch.smpl.constants import default_diff_weights
from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

GRAD_CLIP = 40.0
DEFAULT_LOSS_WEIGHTS = {"r_pos_loss": 1.0, "r_rot_loss": 1.0,
                        "p_rot_loss": 1.0, "vl_loss": 0.1, "va_loss": 0.1,
                        "ee_loss": 1.0}


def make_cc_policy_fn(cc_checkpoint: Dict[str, Any], cc_cfg: Config,
                      device="cuda", dtype=torch.float32):
    """The frozen copycat controller (humanoid_kin_v1.py:99-129): its
    checkpoint's running statistics normalize the obs,
    z = clip((obs − mean) / sqrt(max(m2 / max(n, 1), 1e-8)), ±5), and its
    policy's mean acts on z; weights and statistics in `dtype`."""
    policy = nets.policy_from_numpy(cc_checkpoint["policy_params"],
                                    cc_cfg.policy_htype, device).to(dtype)
    for p in policy.parameters():
        p.requires_grad_(False)
    rs = RN.from_numpy(cc_checkpoint["running_stats"], device)
    mean, m2, n = (x.to(dtype) for x in (rs.mean, rs.m2, rs.n))
    std = torch.sqrt(torch.clamp(m2 / torch.clamp(n, min=1.0), min=1e-8))

    def cc_policy_fn(cc_obs):
        return policy(torch.clamp((cc_obs - mean) / std, -5.0, 5.0))

    return cc_policy_fn


def kin_config(cfg: Config) -> K.KinConfig:
    """The kin env's settings of a config (its model_specs, policy_specs
    and copycat env sections)."""
    d = cfg.cfg_dict
    ms = d.get("model_specs", {}) or {}
    ps = d.get("policy_specs", {}) or {}
    return K.KinConfig(
        pose_delta=ms.get("pose_delta", False),
        remove_base=d.get("remove_base", True),
        env_episode_len=cfg.env.env_episode_len,
        reward_id=ps.get("reward_id", "dynamic_supervision_v1"),
        reward_weights=tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in (ps.get("reward_weights") or {}).items())),
        base_rot=cfg.env.base_rot)


def kin_net_specs(cfg: Config) -> KN.KinNetSpecs:
    d = cfg.cfg_dict
    ms = d.get("model_specs", {}) or {}
    return KN.KinNetSpecs(
        mlp_htype=ms.get("mlp_htype", "relu"),
        mlp_hsize=tuple(ms.get("mlp_hsize", (1024, 512))),
        rnn_hdim=ms.get("rnn_hdim", 512), model_v=ms.get("model_v", 1),
        pose_delta=ms.get("pose_delta", False),
        remove_base=d.get("remove_base", True), base_rot=cfg.env.base_rot,
        log_std=cfg.log_std, env_obs=ms.get("env_obs", False))


def _clip_grads(params, clip: float = GRAD_CLIP):
    """Zero-fill missing gradients (optax steps every leaf), then scale
    all by min(1, clip / (global norm + 1e-8))."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    gnorm = torch.sqrt(sum((p.grad ** 2).sum() for p in params))
    scale = torch.clamp(clip / (gnorm + 1e-8), max=1.0)
    for p in params:
        p.grad.mul_(scale)


class UHMAgent:
    def __init__(self, kin_cfg: Config, motion_file: str,
                 cc_checkpoint_path: Optional[str] = None,
                 num_envs: int = 256, horizon: int = 32, seed: int = 1,
                 max_seq_len: Optional[int] = None,
                 results_dir: Optional[str] = None, device=None):
        self.cfg = kin_cfg
        self.env_cfg = kin_cfg.env
        self.num_envs, self.horizon = num_envs, horizon
        self.device = dev = resolve_device(device)
        self.results_dir = results_dir or os.path.join(
            "results", f"uhm_{kin_cfg.cfg_id}_torch")
        os.makedirs(os.path.join(self.results_dir, "models"), exist_ok=True)

        self.topo, model_np = load_fixture_humanoid()
        self.model = model_from_numpy(model_np, dev)
        self.context_lib, self.seq_keys = build_expert_library(
            self.topo, self.model, load_motion_file(motion_file),
            max_len=max_seq_len)
        jpw, _ = default_diff_weights()
        self.jpos_diffw = torch.as_tensor(jpw, device=dev)

        d = kin_cfg.cfg_dict
        ps = d.get("policy_specs", {}) or {}
        ms = d.get("model_specs", {}) or {}
        self.policy_specs = ps
        self.kin_env_cfg = kin_config(kin_cfg)
        self.specs = kin_net_specs(kin_cfg)
        self.loss_weights = {k: float(v) for k, v in
                             (ps.get("weights") or DEFAULT_LOSS_WEIGHTS)
                             .items()}

        # the frozen low-level controller
        self.cc_action_dim = sum(H.action_dims(self.topo, self.env_cfg))
        self.cc_obs_dim = H.obs_dim(self.topo, self.env_cfg)
        if cc_checkpoint_path is not None:
            self.cc_policy_fn = make_cc_policy_fn(
                joblib_compat.load(cc_checkpoint_path), kin_cfg, dev)
        else:  # an untrained controller (tests, cold start)
            policy = nets.make_policy(kin_cfg, self.cc_obs_dim,
                                      self.cc_action_dim,
                                      torch.Generator().manual_seed(7), dev)
            for p in policy.parameters():
                p.requires_grad_(False)
            self.cc_policy_fn = policy

        # every draw: rollout noise, window and scheduled-sampling draws
        init_gen = torch.Generator().manual_seed(seed)
        self.net = KN.kin_net_init(self.topo, self.specs, init_gen, dev)
        self.value = nets.value_init(KN.kin_obs_dim(self.topo),
                                     kin_cfg.value_hsize, init_gen,
                                     kin_cfg.value_htype, dev)
        self._make_optimizers()
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.gt_rate0 = float(ps.get("gt_rate", 0.3))
        self.gt_rate = self.gt_rate0
        # scheduled-sampling decay (kin_net.py:500-502): gt_rate anneals
        # linearly to 0 after num_epoch_fix epochs
        self.gt_rate_decay = bool(ms.get("gt_rate_decay", True))
        self.num_epoch_fix = int(d.get("num_epoch_fix", 10))
        self.total_epochs = int(d.get("num_epoch", kin_cfg.num_epoch))
        self.sup_window = int(ps.get("window", 32))
        self.sup_batch = int(ps.get("batch", 16))
        self.epoch = 0

    def _make_optimizers(self):
        lr = self.cfg.cfg_dict.get("lr", self.cfg.policy_lr)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=lr)
        self.value_opt = torch.optim.Adam(self.value.parameters(),
                                          lr=self.cfg.value_lr)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def obs(self, states):
        return K.get_ar_obs_v1(self.topo, self.model, self.env_cfg, states,
                               self.context_lib)

    def reset(self, seq_idx) -> K.KinEnvState:
        return K.kin_env_reset(self.topo, self.model, self.kin_env_cfg,
                               seq_idx, self.context_lib)

    def env_step(self, states, action, train: bool = True):
        return K.kin_env_step(self.topo, self.model, self.kin_env_cfg,
                              self.env_cfg, states, action, self.context_lib,
                              self.cc_policy_fn, self.jpos_diffw,
                              train=train)

    # -- hierarchical rollout (agent_uhm.py:164-215) -------------------------
    @torch.no_grad()
    def rollout(self, seq_idx, log_std=None) -> dict:
        """`horizon` steps of B = len(seq_idx) envs from fresh resets, the
        actions the policy mean plus exp(log_std)·N(0, 1) noise from the
        agent's generator (`log_std`, or the net's); a finished episode
        restarts at its context's frame 0, its GRU state at zero. Returns
        (T, B, ...) stacks of obs, action, reward, done and percent."""
        log_std = self.net.log_std if log_std is None else log_std
        fresh = self.reset(seq_idx)
        fresh_obs = self.obs(fresh)
        states, obs = fresh, fresh_obs
        B = obs.shape[0]
        h = obs.new_zeros((B, self.specs.rnn_hdim))
        out = {k: [] for k in ("obs", "action", "reward", "done",
                               "percent")}
        for _ in range(self.horizon):
            mean, h_new = self.net(obs, h)
            action = mean + torch.exp(log_std) * torch.randn(
                mean.shape, generator=self.gen, device=mean.device)
            states2, obs2, reward, _, done = self.env_step(states, action)
            for k, v in (("obs", obs), ("action", action),
                         ("reward", reward), ("done", done),
                         ("percent", states2.percent)):
                out[k].append(v)
            # resets draw nothing: the fresh states of the first step
            states = H.state_where(done, fresh, states2)
            obs = torch.where(done[:, None], fresh_obs, obs2)
            h = torch.where(done[:, None], torch.zeros_like(h_new), h_new)
        return {k: torch.stack(v) for k, v in out.items()}

    # -- PPO over sequences (agent_uhm.py:217-283) ---------------------------
    def seq_log_probs(self, obs_seq, act_seq, done_seq, log_std):
        """(T, B) log-probs re-running the GRU over the rollout, h reset to
        zero after each episode end."""
        h = obs_seq.new_zeros((obs_seq.shape[1], self.specs.rnn_hdim))
        lps = []
        for obs, act, done in zip(obs_seq, act_seq, done_seq):
            mean, h_new = self.net(obs, h)
            lps.append(nets.gaussian_log_prob(mean, log_std, act))
            h = torch.where(done[:, None], torch.zeros_like(h_new), h_new)
        return torch.stack(lps)

    def rl_update(self, traj: dict) -> dict:
        """num_optim_epoch full-batch epochs on one rollout: the value
        step, then the clipped-surrogate policy step (log-std included),
        its gradient clipped to a global norm of 40."""
        cfg = self.cfg
        obs, act = traj["obs"], traj["action"]
        rewards, dones = traj["reward"], traj["done"]
        masks = 1.0 - dones.to(rewards.dtype)
        T, B = rewards.shape
        flat_obs = obs.reshape(T * B, -1)
        with torch.no_grad():
            values = self.value(flat_obs).reshape(T, B)
            adv, ret = estimate_advantages(rewards, masks, values,
                                           torch.zeros_like(values[0]),
                                           cfg.gamma, cfg.tau)
            fixed_lp = self.seq_log_probs(obs, act, dones,
                                          self.net.log_std)
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pparams = list(self.net.parameters())
        for _ in range(cfg.num_optim_epoch):
            self.value_opt.zero_grad(set_to_none=True)
            ((self.value(flat_obs).reshape(T, B) - ret) ** 2).mean() \
                .backward()
            self.value_opt.step()
            self.opt.zero_grad(set_to_none=True)
            lp = self.seq_log_probs(obs, act, dones, self.net.log_std)
            ratio = torch.exp(lp - fixed_lp)
            surr = torch.minimum(ratio * adv, torch.clamp(
                ratio, 1 - cfg.clip_epsilon, 1 + cfg.clip_epsilon) * adv)
            (-surr.mean()).backward()
            _clip_grads(pparams)
            self.opt.step()
        return {"reward_mean": rewards.mean(),
                "episodes": dones.to(rewards.dtype).sum()}

    # -- supervised full update (agent_uhm.py:285-333) -----------------------
    def full_update_on(self, qpos_w, qvel_w, wbpos_w, ss_mask):
        """One supervised step on given windows (N, T, ·) and
        scheduled-sampling mask (N, T) -> the loss before the step."""
        self.opt.zero_grad(set_to_none=True)
        pred = KN.kin_net_rollout(self.net, self.topo, self.model,
                                  self.specs, qpos_w, qvel_w, ss_mask)
        total, _ = KN.kin_net_loss(pred, qpos_w, qvel_w,
                                   wbpos_w.reshape(qpos_w.shape[:2] + (-1,)),
                                   self.loss_weights)
        loss = total.mean()
        loss.backward()
        # early env_obs epochs see gradient norms over 180 (JAX package)
        _clip_grads(list(self.net.parameters()))
        self.opt.step()
        return loss.detach()

    def full_update(self, window: int | None = None,
                    batch: int | None = None) -> float:
        """One supervised epoch: `batch` random GT windows of `window`
        frames (at most the shortest clip) and a Bernoulli(gt_rate)
        scheduled-sampling mask, all from the agent's generator."""
        window = self.sup_window if window is None else window
        batch = self.sup_batch if batch is None else batch
        lib, dev = self.context_lib, self.device
        lengths = lib["len"]
        window = min(window, int(lengths.min()))
        sidx = torch.randint(0, len(self.seq_keys), (batch,),
                             generator=self.gen, device=dev)
        hi = torch.clamp(lengths[sidx] - window, min=1)
        starts = (torch.rand(batch, generator=self.gen, device=dev)
                  * hi).long()
        frames = starts[:, None] + torch.arange(window, device=dev)
        qpos_w, qvel_w, wbpos_w = (lib[k][sidx[:, None], frames]
                                   for k in ("qpos", "qvel", "wbpos"))
        ss = torch.rand((batch, window), generator=self.gen,
                        device=dev) < self.gt_rate
        return float(self.full_update_on(qpos_w, qvel_w, wbpos_w, ss))

    def optimize_policy(self, epoch: int) -> dict:
        """The update_params mixture (agent_uhm.py:543): RL and / or
        supervised, by policy_specs' rl_update / full_update."""
        t0 = time.perf_counter()
        stats: Dict[str, Any] = {}
        if self.gt_rate_decay:
            n, nfix = self.total_epochs, self.num_epoch_fix
            self.gt_rate = self.gt_rate0 * (
                1.0 - max(0, epoch - nfix) / float(n - nfix + 1))
        stats["gt_rate"] = self.gt_rate
        if self.policy_specs.get("rl_update", False):
            seq_idx = torch.randint(0, len(self.seq_keys),
                                    (self.num_envs,), generator=self.gen,
                                    device=self.device)
            traj = self.rollout(seq_idx)
            self._sync()
            t1 = time.perf_counter()
            rl = self.rl_update(traj)
            stats.update({k: float(v) for k, v in rl.items()})
            self._sync()
            t2 = time.perf_counter()
            stats["T_rollout"], stats["T_rl_update"] = t1 - t0, t2 - t1
            stats["rollout_steps_per_sec"] = (self.num_envs * self.horizon
                                              / stats["T_rollout"])
        if self.policy_specs.get("full_update", True):
            t2 = time.perf_counter()
            stats["supervised_loss"] = self.full_update()
            self._sync()
            stats["T_full_update"] = time.perf_counter() - t2
        stats["T_total"] = time.perf_counter() - t0
        self.epoch = epoch
        return stats

    # -- checkpoints (agent_uhm.py:363-385) ----------------------------------
    def checkpoint_path(self, epoch: int) -> str:
        return os.path.join(self.results_dir, "models", f"iter_{epoch:04d}.p")

    def save_checkpoint(self, epoch: int) -> str:
        path = self.checkpoint_path(epoch)
        with open(path, "wb") as f:
            pickle.dump({"params": KN.kin_net_to_numpy(self.net),
                         "value_params": nets.value_to_numpy(self.value),
                         "epoch": epoch}, f)
        return path

    def load_checkpoint(self, epoch: int):
        self.load_checkpoint_file(self.checkpoint_path(epoch))

    def load_checkpoint_file(self, path: str, warm_start: bool = False):
        """Networks from a checkpoint of either package, fresh Adam
        states; warm_start leaves the epoch counter as it is."""
        state = joblib_compat.load(path)
        self.net = KN.kin_net_from_numpy(state["params"], self.specs,
                                         self.device)
        self.value = nets.value_from_numpy(state["value_params"],
                                           self.cfg.value_htype, self.device)
        self._make_optimizers()
        if not warm_start:
            self.epoch = state["epoch"]
