"""Experiment configuration (PyTorch-port twin of uhc_tpu.config.config).

Field names follow the reference YAML schema (config/release/*.yml,
uhc/utils/config_utils/copycat_config.py:16-149) so reference experiment
files load unchanged. The env-side subset is a frozen dataclass, fixed per
experiment. `Config.uhc_implicit()` and `Config.uhc_implicit_shape()`
build the release configs without YAML; `Config.preset(name)` looks them
up by name, and `Config.named(name)`, the CLIs' --cfg, takes a preset or
`<name>.yml` from config/ or this package's directory, which holds the
explicit-RFC (`explicit.yml`, `EXPLICIT`) and per-joint meta-PD
(`meta_joint.yml`, `META_JOINT`) variants of uhc_implicit.
"""
from __future__ import annotations

import dataclasses
import glob
import os.path as osp
from typing import Any, Dict, Tuple

import numpy as np

# where Config.from_yaml looks for <cfg_id>.yml: the repository's config/
# and this package's own directory
YAML_DIRS = ("config", osp.dirname(osp.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static env hyper-parameters (frozen, hashable)."""

    obs_v: int = 2
    # obs_v3 future-frame stacking (reference humanoid_im.py:759-762 reads
    # cc_cfg fut_frames / skip)
    fut_frames: int = 10
    obs_skip: int = 10
    obs_coord: str = "root"
    obs_vel: str = "full"
    obs_phase: bool = False
    obs_heading: bool = False
    root_deheading: bool = False
    action_v: int = 1
    action_type: str = "position"
    reactive_v: int = 1
    reactive_rate: float = 0.3
    env_episode_len: int = 100000
    env_expert_trail_steps: int = 0
    env_term_body: str = "body"
    env_init_noise: float = 0.0
    body_diff_thresh: float = 0.5
    body_diff_thresh_test: float = 0.5
    residual_force: bool = True
    residual_force_scale: float = 100.0
    residual_force_lim: float = 100.0
    residual_force_mode: str = "implicit"
    residual_force_torque: bool = True
    residual_force_bodies_num: int = 1
    # explicit-RFC contact gating / projection (humanoid_im.py:1083-1108)
    residual_contact_only: bool = False
    residual_contact_only_ground: bool = False
    residual_contact_projection: bool = False
    rfc_decay: bool = False
    meta_pd: bool = True
    meta_pd_joint: bool = False
    # body-body contacts over the curated pair set (engine
    # self_collision_terms, calibrated against CPU MuJoCo in
    # tests/test_self_collision_oracle.py). ON by default to match the
    # reference: MuJoCo collides all humanoid geoms in one
    # contype/conaffinity group (smpl_parser.py:315-329); the fused kernel
    # covers it in-kernel.
    self_collision: bool = True
    t_min: int = 15      # data_specs window bounds (dataset_amass_single.py)
    t_max: int = 300
    # robot family: "smpl" (24 bodies) or "smplh" (52, articulated hands)
    # (copycat_config.py:121 robot_cfg["model"])
    robot_model: str = "smpl"
    # ball-joint (quaternion) variant (robot_cfg["ball"],
    # humanoid_im.py:52 use_quat; config/copycat_ball/*.yml): qpos carries a
    # quaternion per joint, control is direct torque, obs is v2_quat
    robot_ball: bool = False
    # foot-model variants (config/masterfoot, config/bigfoot)
    masterfoot: bool = False
    master_range: float = 30.0
    bigfoot: bool = False
    has_shape: bool = False
    has_shape_obs: bool = True
    # shape-obs composition (humanoid_im.py:1390 get_expert_shape_and_gender)
    has_pca: bool = True
    has_weight: bool = False
    has_bone_length: bool = False
    frame_skip: int = 15
    base_rot: Tuple[float, ...] = (0.7071, 0.7071, 0.0, 0.0)
    # reward
    reward_id: str = "world_rfc_implicit"
    w_p: float = 0.6
    w_v: float = 0.1
    w_e: float = 0.2
    w_c: float = 0.1
    w_vf: float = 0.0
    k_p: float = 2.0
    k_v: float = 0.005
    k_e: float = 20.0
    k_c: float = 1000.0
    k_vf: float = 1.0
    # remaining reward_weights entries (local/v2/v3 reward families use
    # ws.get(...) lookups with per-function defaults, reward_function.py:437-
    # 760); kept as a sorted tuple of pairs so EnvConfig stays hashable.
    extra_rw: Tuple[Tuple[str, Any], ...] = ()

    def rw(self, name: str, default):
        """reward_weights.get(name, default) over the raw YAML dict."""
        for k, v in self.extra_rw:
            if k == name:
                return v
        return default

    @property
    def ctrl_dt(self) -> float:
        return self.frame_skip / 450.0


@dataclasses.dataclass
class Config:
    """Full experiment config loaded from a reference-format YAML file."""

    cfg_id: str = "default"
    cfg_dict: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # training
    gamma: float = 0.95
    tau: float = 0.95
    policy_htype: str = "relu"
    policy_hsize: Tuple[int, ...] = (512, 256)
    policy_lr: float = 5e-5
    value_htype: str = "relu"
    value_hsize: Tuple[int, ...] = (512, 256)
    value_lr: float = 3e-4
    clip_epsilon: float = 0.2
    min_batch_size: int = 50000
    mini_batch_size: int = 32768
    num_optim_epoch: int = 10
    log_std: float = -2.3
    fix_std: bool = True
    num_epoch: int = 30000
    seed: int = 1
    save_n_epochs: int = 100
    actor_type: str = "mcp"
    num_primitive: int = 8
    composer_dim: Tuple[int, ...] = (300, 200)
    sampling_temp: float = 0.2
    sampling_freq: float = 0.75
    # failure-frame-targeted restarts (agent_copycat.py:103; the per-seq
    # fit protocol switches it on, fit_uhc.py:111)
    precision_mode: bool = False
    end_reward: bool = False
    # adv_clip is parsed for YAML parity but — exactly like the reference
    # (copycat_config.py:31 is its only occurrence; no agent reads it) —
    # intentionally unused.
    adv_clip: float = float("inf")
    # adaptive schedules (copycat_config.py:151 update_adaptive_params)
    adp_iter_cp: Tuple[int, ...] = (0,)
    adp_noise_rate_cp: Tuple[float, ...] = (1.0,)
    adp_log_std_cp: Tuple[float, ...] = (-2.3,)
    adp_policy_lr_cp: Tuple[float, ...] = (5e-5,)

    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    data_specs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    results_dir: str = "results"

    def adaptive_params(self, i_iter: int):
        """Piecewise-linear schedules for noise / log_std / lr
        (copycat_config.py:151 update_adaptive_params)."""
        cp = np.array(self.adp_iter_cp)

        def interp(vals):
            vals = np.pad(np.array(vals, float), (0, len(cp) - len(vals)),
                          "edge")
            ind = int(np.where(i_iter >= cp)[0][-1])
            nind = ind + int(ind < len(cp) - 1)
            t = ((i_iter - cp[ind]) / (cp[nind] - cp[ind])) if nind > ind \
                else 0.0
            return float(vals[ind] * (1 - t) + vals[nind] * t)

        return (interp(self.adp_noise_rate_cp), interp(self.adp_log_std_cp),
                interp(self.adp_policy_lr_cp))

    @classmethod
    def from_yaml(cls, cfg_id: str, search_dirs=YAML_DIRS) -> "Config":
        """Load `<cfg_id>.yml` from `search_dirs` (needs PyYAML)."""
        import yaml

        path = None
        for d in search_dirs:
            hits = glob.glob(osp.join(d, "**", f"{cfg_id}.yml"), recursive=True)
            if hits:
                path = hits[0]
                break
        if path is None:
            raise FileNotFoundError(f"config {cfg_id}.yml not found in {search_dirs}")
        with open(path) as f:
            d = yaml.safe_load(f)
        return cls.from_dict(cfg_id, d)

    @classmethod
    def uhc_implicit(cls) -> "Config":
        """The release uhc_implicit config (`UHC_IMPLICIT`), without YAML."""
        return cls.from_dict("uhc_implicit", UHC_IMPLICIT)

    @classmethod
    def uhc_implicit_shape(cls) -> "Config":
        """The shape-conditioned release config (`UHC_IMPLICIT_SHAPE`),
        without YAML."""
        return cls.from_dict("uhc_implicit_shape", UHC_IMPLICIT_SHAPE)

    @classmethod
    def preset(cls, name: str) -> "Config":
        """A config by preset name (the CLIs' --cfg)."""
        if name not in PRESETS:
            raise ValueError(f"unknown config {name!r}; presets: "
                             f"{sorted(PRESETS)}")
        return cls.from_dict(name, PRESETS[name])

    @classmethod
    def named(cls, name: str) -> "Config":
        """The CLIs' --cfg: a preset, else `<name>.yml` (`from_yaml`)."""
        if name in PRESETS:
            return cls.preset(name)
        try:
            return cls.from_yaml(name)
        except FileNotFoundError:
            raise ValueError(f"unknown config {name!r}: no preset of "
                             f"{sorted(PRESETS)} and no {name}.yml in "
                             f"{YAML_DIRS}") from None

    @classmethod
    def from_dict(cls, cfg_id: str, d: Dict[str, Any]) -> "Config":
        rw = d.get("reward_weights") or {}
        env = EnvConfig(
            obs_v=d.get("obs_v", 0),
            fut_frames=d.get("fut_frames", 10),
            obs_skip=d.get("skip", 10),
            obs_coord=d.get("obs_coord", "root"),
            obs_vel=d.get("obs_vel", "full"),
            obs_phase=d.get("obs_phase", True),
            obs_heading=d.get("obs_heading", False),
            root_deheading=d.get("root_deheading", False),
            action_v=d.get("action_v", 0),
            action_type=d.get("action_type", "position"),
            reactive_v=d.get("reactive_v", 0),
            reactive_rate=d.get("reactive_rate", 0.3),
            env_episode_len=d.get("env_episode_len", 200),
            env_expert_trail_steps=d.get("env_expert_trail_steps", 0),
            env_term_body=d.get("env_term_body", "head"),
            env_init_noise=d.get("env_init_noise", 0.0),
            body_diff_thresh=d.get("body_diff_thresh", 0.5),
            body_diff_thresh_test=d.get("body_diff_thresh_test", 0.5),
            residual_force=d.get("residual_force", False),
            residual_force_scale=d.get("residual_force_scale", 200.0),
            residual_force_lim=d.get("residual_force_lim", 100.0),
            residual_force_mode=d.get("residual_force_mode", "implicit"),
            residual_force_torque=bool(d.get("residual_force_torque", True)),
            residual_force_bodies_num=d.get("residual_force_bodies_num", 1),
            residual_contact_only=d.get("residual_contact_only", False),
            residual_contact_only_ground=d.get(
                "residual_contact_only_ground", False),
            residual_contact_projection=d.get(
                "residual_contact_projection", False),
            rfc_decay=d.get("rfc_decay", False),
            meta_pd=d.get("meta_pd", False),
            meta_pd_joint=d.get("meta_pd_joint", False),
            self_collision=d.get("self_collision", True),
            t_min=d.get("data_specs", {}).get("t_min", 15),
            t_max=d.get("data_specs", {}).get("t_max", 300),
            robot_model=d.get("robot", {}).get("model", "smpl"),
            robot_ball=bool(d.get("robot", {}).get("ball", False)),
            masterfoot=d.get("masterfoot", False),
            master_range=d.get("master_range", 30.0),
            bigfoot="bigfoot" in d.get("mujoco_model", ""),
            has_shape=d.get("has_shape", False),
            has_shape_obs=d.get("has_shape_obs", True),
            has_pca=d.get("has_pca", True),
            has_weight=d.get("has_weight", False),
            has_bone_length=d.get("has_bone_length", False),
            base_rot=tuple(d.get("data_specs", {}).get("base_rot", (0.7071, 0.7071, 0.0, 0.0))),
            reward_id=d.get("reward_id", "quat"),
            w_p=rw.get("w_p", 0.6), w_v=rw.get("w_v", 0.1),
            w_e=rw.get("w_e", 0.2), w_c=rw.get("w_c", 0.1),
            w_vf=rw.get("w_vf", 0.0),
            k_p=rw.get("k_p", 2.0), k_v=rw.get("k_v", 0.005),
            k_e=rw.get("k_e", 20.0), k_c=rw.get("k_c", 1000.0),
            k_vf=rw.get("k_vf", 1.0),
            extra_rw=tuple(sorted(
                (k, tuple(v) if isinstance(v, list) else v)
                for k, v in rw.items())),
        )
        log_std = d.get("log_std", -2.3)
        lr = d.get("policy_lr", 5e-5)
        return cls(
            cfg_id=cfg_id,
            cfg_dict=d,
            gamma=d.get("gamma", 0.95),
            tau=d.get("tau", 0.95),
            policy_htype=d.get("policy_htype", "relu"),
            policy_hsize=tuple(d.get("policy_hsize", (300, 200))),
            policy_lr=lr,
            value_htype=d.get("value_htype", "relu"),
            value_hsize=tuple(d.get("value_hsize", (300, 200))),
            value_lr=d.get("value_lr", 3e-4),
            clip_epsilon=d.get("clip_epsilon", 0.2),
            min_batch_size=d.get("min_batch_size", 50000),
            mini_batch_size=d.get("mini_batch_size", d.get("min_batch_size", 50000)),
            num_optim_epoch=d.get("num_optim_epoch", 10),
            log_std=log_std,
            fix_std=d.get("fix_std", False),
            num_epoch=d.get("num_epoch", 30000),
            seed=d.get("seed", 1),
            save_n_epochs=d.get("save_n_epochs", 100),
            actor_type=d.get("actor_type", "gauss"),
            num_primitive=d.get("num_primitive", 8),
            composer_dim=tuple(d.get("composer_dim", [(300, 200)])[0]) if isinstance(
                d.get("composer_dim", [[300, 200]])[0], (list, tuple)) else tuple(d.get("composer_dim")),
            sampling_temp=d.get("sampling_temp", 0.2),
            sampling_freq=d.get("sampling_freq", 0.75),
            precision_mode=d.get("precision_mode", False),
            end_reward=d.get("end_reward", False),
            adp_iter_cp=tuple(d.get("adp_iter_cp", (0,))),
            adp_noise_rate_cp=tuple(d.get("adp_noise_rate_cp", (1.0,))),
            adp_log_std_cp=tuple(d.get("adp_log_std_cp", (log_std,))),
            adp_policy_lr_cp=tuple(d.get("adp_policy_lr_cp", (lr,))),
            env=env,
            data_specs=d.get("data_specs", {}),
        )


# The env, reward and policy sections of config/uhm_1.yml (its own comment:
# an exact copy of release/uhc_implicit.yml): obs_v 1, implicit RFC, plain
# PD (no meta_pd key -> False), self-collision at the EnvConfig default,
# an 8-primitive MCP policy with 512-256 trunks.
UHC_IMPLICIT = {
    "gamma": 0.95, "tau": 0.95,
    "policy_htype": "relu", "policy_hsize": [512, 256],
    "policy_lr": 5.e-5,
    "value_htype": "relu", "value_hsize": [512, 256], "value_lr": 3.e-4,
    "clip_epsilon": 0.2, "min_batch_size": 50000,
    "mini_batch_size": 32768, "num_optim_epoch": 10,
    "log_std": -2.3, "fix_std": True, "num_epoch": 30000, "seed": 1,
    "save_n_epochs": 100,
    "reward_id": "world_rfc_implicit", "obs_type": "full",
    "actor_type": "mcp", "num_primitive": 8,
    "action_v": 1, "obs_v": 1, "reactive_v": 1, "reactive_rate": 0.3,
    "sampling_temp": 0.2, "has_shape": False,
    "reward_weights": {"w_p": 0.3, "w_v": 0.1, "w_e": 0.45, "w_c": 0.1,
                       "w_vf": 0.05, "k_p": 2.0, "k_v": 0.005, "k_e": 5.0,
                       "k_c": 100.0, "k_vf": 1.0},
    "data_specs": {"dataset_name": "amass", "flip_cnd": 0,
                   "has_smpl_root": True, "traj_dim": 144, "t_min": 15,
                   "t_max": 300, "nc": 2, "load_class": -1,
                   "adaptive_iter": 200, "root_dim": 6, "flip_time": False,
                   "mode": "all", "base_rot": [0.7071, 0.7071, 0.0, 0.0]},
    "env_episode_len": 100000, "env_term_body": "body",
    "env_expert_trail_steps": 0, "obs_coord": "root", "obs_phase": False,
    "residual_force": True, "residual_force_scale": 100.0,
    "residual_force_mode": "implicit",
}


# The shape-conditioned release config (reference
# config/release/uhc_implicit_shape.yml, which is not in the repository),
# built from what the repository records of it:
#   has_shape, obs_v 2, fut_frames 3, skip 10   tests/test_shape.py:134-140
#   shape obs = beta(16) + gender (has_pca; no weight, no bone length),
#     obs_dim 640 + 17 = 657      uhc_tpu/envs/humanoid_im.py:695-700 and
#                                 results/uhc_implicit_shape_r4/log/log.txt
#   meta_pd                       action_dim 105 = 69 + 6 (RFC) + 2 · 15
#   gauss policy 2048-1024-512, gelu          BASELINE.md:17
#   value 2048-1024-512, log_std -2.3 held fixed (constant over 1000
#     epochs)                     results/uhc_implicit_shape_r4/models
# Every other field is UHC_IMPLICIT's: gamma, tau, the learning rates,
# clip_epsilon, batch sizes, num_optim_epoch, seed, save_n_epochs,
# value_htype (relu), reward_id and reward_weights, action_v, reactive_v,
# reactive_rate, sampling_temp, data_specs (t_min, t_max, base_rot),
# env_episode_len, env_term_body, obs_coord, obs_phase and the residual
# force settings. Correct them here once the release YAML is available.
UHC_IMPLICIT_SHAPE = {
    **UHC_IMPLICIT,
    "has_shape": True, "has_shape_obs": True, "has_pca": True,
    "has_weight": False, "has_bone_length": False,
    "obs_v": 2, "fut_frames": 3, "skip": 10,
    "meta_pd": True,
    "actor_type": "gauss", "policy_htype": "gelu",
    "policy_hsize": [2048, 1024, 512], "value_hsize": [2048, 1024, 512],
    "log_std": -2.3, "fix_std": True,
}

PRESETS = {"uhc_implicit": UHC_IMPLICIT,
           "uhc_implicit_shape": UHC_IMPLICIT_SHAPE}

# uhc_implicit with explicit residual force control: a [cp|f|τ] slot per
# body (9 · 24 RFC columns, A = 69 + 216 = 285), the contact point
# projected into the body's hull, the world_rfc_explicit reward
# (humanoid_im.py:1080-1132 rfc_explicit; uhc_tpu/config/config.py reads
# the same keys). The contact gate (residual_contact_only) stays off, as
# in training. `explicit.yml` beside this file holds the same dict; the
# release uhc_explicit.yml (meta-PD over a shaped library) is not in the
# repository.
EXPLICIT = {
    **UHC_IMPLICIT,
    "residual_force_mode": "explicit", "residual_force_torque": True,
    "residual_force_bodies_num": 1, "residual_contact_projection": True,
    "reward_id": "world_rfc_explicit",
}

# uhc_implicit with per-joint meta-PD: a kp and a kd scale per dof for the
# whole control step (A = 69 + 6 + 2 · 69 = 213; humanoid_im.py:1053-1064)
# in place of plain PD. `meta_joint.yml` beside this file holds the same
# dict.
META_JOINT = {**UHC_IMPLICIT, "meta_pd": False, "meta_pd_joint": True}
