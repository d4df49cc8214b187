"""Evaluation CLI (PyTorch twin of uhc_tpu.cli.eval): closed-loop copycat
evaluation of every clip of a motion file, on the stand-in humanoid.

Usage:
  python -m uhc_tpu_torch.cli.eval [--cfg uhc_implicit]
      --motion sample_data/gait_clips.pkl [--checkpoint PATH]
      [--smpl-data SMPL.pkl] [--device cpu] [--seed 0] [--max-seq-len N]

Without --checkpoint the policy weights are drawn from --seed at the
config's shapes. --cfg takes a preset or a YAML config by name, as
cli/train does. With --cfg uhc_implicit_shape every clip runs on its own
body from its betas (synthetic blendshapes without --smpl-data), and the
summary adds vertex penetration and skate. Prints per-sequence metrics and
one SUMMARY JSON line. Physics runs through the control-step kernel on
CUDA (K1, K1e over a shaped library, K1f for explicit RFC or per-joint
meta-PD; the plain PyTorch version on the CPU).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from uhc_tpu_torch.device import resolve_device


def run_eval(motion: str, checkpoint: str | None = None, device=None,
             seed: int = 0, max_seq_len: int | None = None,
             cfg="uhc_implicit", smpl_data=None) -> dict:
    """Build the stand-in humanoid, expert library and policy, run the
    closed-loop evaluation; returns {"summary", "per_seq", "control_steps",
    "seconds", "ms_per_step", "traj", "policy", "rs"}. `cfg` is a Config
    or a name for `Config.named`."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.data.dataset import (load_motion_file,
                                            neutral_from_library)
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.agent import build_library, root_offsets
    from uhc_tpu_torch.learn.evaluate import make_eval_fn, summarize
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.constants import default_diff_weights
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    dev = resolve_device(device)
    if not isinstance(cfg, Config):
        cfg = Config.named(cfg)
    topo, model_np = load_fixture_humanoid()
    model = model_from_numpy(model_np, dev)
    lib, keys, sim_model, smpl_data = build_library(
        topo, model, cfg.env, load_motion_file(motion), smpl_data,
        max_len=max_seq_len)
    nq, nv = neutral_from_library(lib)
    jpw, bdw = default_diff_weights()
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.as_tensor(jpw, device=dev),
           "body_diffw": torch.as_tensor(bdw, device=dev)}
    obs_dim = H.obs_dim(topo, cfg.env)
    act_dim = sum(H.action_dims(topo, cfg.env))
    if checkpoint:
        ck = joblib_compat.load(checkpoint)
        policy = nets.policy_from_numpy(ck["policy_params"],
                                        cfg.policy_htype, dev)
        rs = RN.from_numpy(ck["running_stats"], dev)
    else:
        policy = nets.make_policy(cfg, obs_dim, act_dim,
                                  torch.Generator().manual_seed(seed), dev)
        # unit normalization: fresh statistics (n=0) would divide by 1e-8
        # and turn every observation into a ±5 sign
        rs = RN.RunningStats(torch.tensor(2.0, device=dev),
                             torch.zeros(obs_dim, device=dev),
                             torch.ones(obs_dim, device=dev))
    max_steps = int(lib["len"].max()) - 1
    eval_fn = make_eval_fn(topo, cfg.env, policy, max_steps,
                           fused_model=sim_model)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    traj, fail_safe, percent = eval_fn(sim_model, lib, aux, rs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    res = summarize(traj, fail_safe, percent, lib, keys,
                    smpl_data=smpl_data, root_offset=root_offsets(sim_model))
    res.update(control_steps=max_steps, seconds=secs,
               ms_per_step=1000.0 * secs / max_steps, traj=traj,
               policy=policy, rs=rs)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m uhc_tpu_torch.cli.eval")
    p.add_argument("--cfg", default="uhc_implicit",
                   help="config preset (uhc_implicit, uhc_implicit_shape) "
                        "or <name>.yml (explicit, meta_joint)")
    p.add_argument("--motion", default="sample_data/gait_clips.pkl")
    p.add_argument("--smpl-data", default=None,
                   help="SMPL model pkl/npz (shaped bodies, vertex metrics)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint pickle (policy_params, running_stats)")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-seq-len", type=int, default=None)
    args = p.parse_args(argv)
    res = run_eval(args.motion, args.checkpoint, args.device, args.seed,
                   args.max_seq_len, args.cfg, args.smpl_data)
    for k, m in res["per_seq"].items():
        print(k, json.dumps({kk: round(vv, 2) for kk, vv in m.items()}))
    print("SUMMARY", json.dumps(res["summary"]))
    return res


if __name__ == "__main__":
    main()
