"""Evaluation CLI (PyTorch twin of uhc_tpu.cli.eval): closed-loop copycat
evaluation of every clip of a motion file, on the tree the config names,
built from the stand-in humanoid as the agent builds it
(`learn.agent.robot_family`: SMPL-H for `robot: {model: smplh}`, the
enlarged feet of bigfoot, masterfoot's 48 bodies for `masterfoot: true`).

Usage:
  python -m uhc_tpu_torch.cli.eval [--cfg uhc_implicit]
      --motion sample_data/gait_clips.pkl
      [--checkpoint PATH | --epoch N [--results-dir DIR]]
      [--singles-dir DIR] [--dump PATH]
      [--smpl-data SMPL.pkl] [--device cpu] [--seed 0] [--max-seq-len N]

--epoch N loads DIR/models/iter_NNNN.p (DIR: --results-dir, default
results/<cfg>_torch; a JAX run's results directory works as well).
Without --checkpoint or --epoch the policy weights are drawn from --seed
at the config's shapes. --singles-dir names a directory of per-sequence
policies (`<key>.p` from cli/fit, of either package): every clip with
one runs under its own policy and running statistics, the rest under the
base checkpoint, all in one batched forward a control step, and
`singles: k/S fitted (keys)` is printed. --dump writes every clip's
predicted and reference trajectories as a plain pickle {key: {pred_qpos,
pred_jpos, gt_qpos, gt_jpos, fail_safe, percent}}, which
cli/eval_imitation (or the JAX package's) re-scores. --cfg takes a
preset or a YAML config by name, as cli/train does. With --cfg
uhc_implicit_shape every clip runs on its own body from its betas
(synthetic blendshapes without --smpl-data), and the summary adds vertex
penetration and skate. Prints per-sequence metrics and one SUMMARY JSON
line. Physics runs through the control-step kernel on CUDA (K1, K1e over
a shaped library, K1f for explicit RFC or per-joint meta-PD, K1d on the
big trees); on the CPU through the plain PCG-5 chain, as the agent does
and as the JAX eval runs XLA off its TPU.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import torch

from uhc_tpu_torch.device import resolve_device


def run_eval(motion: str, checkpoint: str | None = None, device=None,
             seed: int = 0, max_seq_len: int | None = None,
             cfg="uhc_implicit", smpl_data=None, epoch: int | None = None,
             results_dir: str | None = None,
             singles_dir: str | None = None) -> dict:
    """Build the configured tree from the stand-in humanoid, its expert
    library and the policy at its widths, run the closed-loop evaluation;
    returns {"summary", "per_seq", "control_steps", "seconds",
    "ms_per_step", "traj", "fail_safe", "percent", "policy", "rs",
    "fitted", "lib", "keys"}. `cfg` is a Config or a name for
    `Config.named`. `epoch` loads that checkpoint of `results_dir`
    (default: the config's); `singles_dir` adds per-sequence policies
    (`fitted` lists the clips that have one)."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.data.dataset import (load_motion_file,
                                            neutral_from_library)
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.agent import (build_library, checkpoint_path,
                                           default_results_dir,
                                           robot_family, root_offsets)
    from uhc_tpu_torch.learn.evaluate import make_eval_fn, summarize
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    dev = resolve_device(device)
    if not isinstance(cfg, Config):
        cfg = Config.named(cfg)
    topo, model_np, converter, jpw, bdw = robot_family(
        *load_fixture_humanoid(), cfg.env, smpl_data)
    model = model_from_numpy(model_np, dev)
    lib, keys, sim_model, smpl_data = build_library(
        topo, model, cfg.env, load_motion_file(motion), smpl_data,
        max_len=max_seq_len, converter=converter)
    nq, nv = neutral_from_library(lib)
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.as_tensor(jpw, device=dev),
           "body_diffw": torch.as_tensor(bdw, device=dev)}
    obs_dim = H.obs_dim(topo, cfg.env)
    act_dim = sum(H.action_dims(topo, cfg.env))
    if epoch is not None:
        checkpoint = checkpoint_path(results_dir or default_results_dir(cfg),
                                     epoch)
    fitted = []
    if checkpoint:
        ck = joblib_compat.load(checkpoint)
        policy = nets.policy_from_numpy(ck["policy_params"],
                                        cfg.policy_htype, dev)
        rs = RN.from_numpy(ck["running_stats"], dev)
        if singles_dir:
            policies, stats = [], []
            for key in keys:
                path = os.path.join(singles_dir, f"{key}.p")
                if os.path.exists(path):
                    d = joblib_compat.load(path)
                    policies.append(nets.policy_from_numpy(
                        d["policy_params"], cfg.policy_htype, dev))
                    stats.append(RN.from_numpy(d["running_stats"], dev))
                    fitted.append(key)
                else:
                    policies.append(policy)
                    stats.append(rs)
            print(f"singles: {len(fitted)}/{len(keys)} fitted "
                  f"({', '.join(fitted)})", flush=True)
            policy, rs = nets.stack_policies(policies), RN.stack(stats)
    elif singles_dir:
        raise ValueError("--singles-dir needs a base checkpoint "
                         "(--checkpoint or --epoch)")
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
                           fused_model=(sim_model if dev.type == "cuda"
                                        else None),
                           per_seq_params=bool(singles_dir))
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
               fail_safe=fail_safe, percent=percent, policy=policy, rs=rs,
               fitted=fitted, lib=lib, keys=keys)
    return res


def dump_trajectories(res: dict, path: str) -> int:
    """Write run_eval's trajectories as a plain pickle {key: {pred_qpos,
    pred_jpos, gt_qpos, gt_jpos, fail_safe, percent}} of numpy arrays,
    sliced as the JAX eval CLI slices them (the first T = len - 1
    predicted frames against reference frames 1..T); returns the number
    of clips."""
    lib = res["lib"]
    pred_q = res["traj"]["pred_qpos"].cpu().numpy()
    pred_j = res["traj"]["pred_jpos"].cpu().numpy()
    lens = lib["len"].cpu().numpy()
    gt_q, gt_j = lib["qpos"].cpu().numpy(), lib["wbpos"].cpu().numpy()
    fail_safe = res["fail_safe"].cpu().numpy()
    percent = res["percent"].cpu().numpy()
    out = {}
    for s, key in enumerate(res["keys"]):
        T = int(lens[s]) - 1
        out[key] = {"pred_qpos": pred_q[s][:T], "pred_jpos": pred_j[s][:T],
                    "gt_qpos": gt_q[s][1:T + 1], "gt_jpos": gt_j[s][1:T + 1],
                    "fail_safe": bool(fail_safe[s]),
                    "percent": float(percent[s])}
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return len(out)


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
    p.add_argument("--epoch", type=int, default=None,
                   help="load <results-dir>/models/iter_NNNN.p")
    p.add_argument("--results-dir", default=None,
                   help="checkpoint directory (default results/<cfg>_torch)")
    p.add_argument("--singles-dir", default=None,
                   help="directory of per-sequence policies (<key>.p from "
                        "cli/fit): sequences with one evaluate under it, "
                        "the rest under the base checkpoint")
    p.add_argument("--dump", default=None,
                   help="write per-sequence gt/pred trajectories to this "
                        "pickle (read by cli/eval_imitation)")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-seq-len", type=int, default=None)
    args = p.parse_args(argv)
    if args.checkpoint and args.epoch is not None:
        p.error("give --checkpoint or --epoch, not both")
    res = run_eval(args.motion, args.checkpoint, args.device, args.seed,
                   args.max_seq_len, args.cfg, args.smpl_data, args.epoch,
                   args.results_dir, args.singles_dir)
    for k, m in res["per_seq"].items():
        print(k, json.dumps({kk: round(vv, 2) for kk, vv in m.items()}))
    print("SUMMARY", json.dumps(res["summary"]))
    if args.dump:
        n = dump_trajectories(res, args.dump)
        print(f"dumped {n} sequences -> {args.dump}")
    return res


if __name__ == "__main__":
    main()
