"""Kinematic-policy (UHM / relive) evaluation CLI (PyTorch twin of
uhc_tpu.cli.eval_relive, reference scripts/eval_relive.py).

Every sequence of the motion file rolls out at once through the kin env:
the policy's mean action each control step, the frozen copycat tracking
its integrated targets on the exact chain, a sequence's state held once
it reaches its last frame. Writes <results-dir>/eval_relive_NNNN.json
({"summary", "per_seq"}, the JAX package's keys: succ, mpjpe, pa_mpjpe,
mpjpe_g, root_dist, vel_dist, accel_dist, and coverage in the summary).

Usage:
  python -m uhc_tpu_torch.cli.eval_relive [--cfg uhm_1] --epoch N
      [--results-dir DIR] [--cc-checkpoint PATH]
      [--data sample_data/gait_clips.pkl] [--max-seq-len N]
      [--dump out.pkl] [--device cpu]

--results-dir defaults to results/uhm_<cfg>_torch; a JAX run's directory
(results/uhm_1) loads as well. --dump writes {key: {pred, gt, percent
[, obj_pose]}} as a plain pickle. Runs on CUDA unless --device says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m uhc_tpu_torch.cli.eval_relive")
    p.add_argument("--cfg", default="uhm_1")
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--cc-checkpoint", default=None,
                   help="frozen copycat checkpoint")
    p.add_argument("--data", default="sample_data/gait_clips.pkl")
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument("--dump", default=None)
    p.add_argument("--results-dir", default=None,
                   help="checkpoint directory (default "
                        "results/uhm_<cfg>_torch)")
    p.add_argument("--device", default=None, help="default: cuda")
    return p


@torch.no_grad()
def rollout_all(agent) -> dict:
    """Deterministic closed loop of every sequence of the agent's library:
    (S, T, ·) pred_qpos, percent and, with a track, obj_pose, T the
    longest clip's length less one; row s holds still after len_s - 1
    steps."""
    from uhc_tpu_torch.envs import humanoid_im as H

    lib = agent.context_lib
    S = int(lib["len"].shape[0])
    seq_idx = torch.arange(S, device=lib["len"].device)
    states = agent.reset(seq_idx)
    obs = agent.obs(states)
    h = obs.new_zeros((S, agent.specs.rnn_hdim))
    lengths = lib["len"]
    out = {"pred_qpos": [], "percent": []}
    for t in range(int(lengths.max()) - 1):
        active = t < (lengths - 1)
        mean, h_new = agent.net(obs, h)
        states2, obs2, _, _, _ = agent.env_step(states, mean)
        states = H.state_where(active, states2, states)
        obs = torch.where(active[:, None], obs2, obs)
        h = torch.where(active[:, None], h_new, h)
        out["pred_qpos"].append(states.qpos)
        out["percent"].append(states.percent)
        if states.obj_qpos is not None:
            out.setdefault("obj_pose", []).append(states.obj_qpos)
    return {k: torch.stack(v, 1) for k, v in out.items()}


def main(argv=None) -> dict:
    """Evaluate; returns {"summary", "per_seq", "traj", "control_steps",
    "ms_per_step", "path", "agent"}."""
    args = parser().parse_args(argv)
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.envs.expert import qpos_fk
    from uhc_tpu_torch.learn.agent_uhm import UHMAgent
    from uhc_tpu_torch.learn.metrics import compute_metrics

    cfg = Config.named(args.cfg)
    agent = UHMAgent(cfg, args.data, cc_checkpoint_path=args.cc_checkpoint,
                     num_envs=1, horizon=1, max_seq_len=args.max_seq_len,
                     results_dir=args.results_dir, device=args.device)
    agent.load_checkpoint(args.epoch)
    lib = agent.context_lib
    t0 = time.perf_counter()
    traj = rollout_all(agent)
    agent._sync()
    seconds = time.perf_counter() - t0
    steps = int(lib["len"].max()) - 1
    lens = lib["len"].cpu().numpy()
    gt_q, gt_j = lib["qpos"].cpu().numpy(), lib["wbpos"].cpu().numpy()
    results, dump = {}, {}
    for s, key in enumerate(agent.seq_keys):
        T = int(lens[s]) - 1
        pred = traj["pred_qpos"][s, :T]
        pred_j = qpos_fk(agent.topo, agent.model, pred)["wbpos"]
        pred_q = pred.cpu().numpy()
        percent = float(traj["percent"][s, T - 1]) if T > 0 else 0.0
        m = compute_metrics(pred_q, gt_q[s, 1:T + 1],
                            pred_j.cpu().numpy(), gt_j[s, 1:T + 1], False,
                            percent)
        results[key] = m
        print(key, json.dumps({k: round(v, 2) for k, v in m.items()}))
        if args.dump:
            dump[key] = {"pred": pred_q, "gt": gt_q[s, 1:T + 1],
                         "percent": percent}
            if "obj_pose" in traj:
                dump[key]["obj_pose"] = traj["obj_pose"][s, :T].cpu().numpy()
    agg = {k: float(np.mean([m[k] for m in results.values()]))
           for k in next(iter(results.values()))}
    agg["coverage"] = int(sum(m["succ"] for m in results.values()))
    print("SUMMARY", json.dumps(agg, indent=2))
    path = os.path.join(agent.results_dir,
                        f"eval_relive_{args.epoch:04d}.json")
    with open(path, "w") as f:
        json.dump({"summary": agg, "per_seq": results}, f, indent=1)
    print(f"wrote {path}")
    if args.dump:
        with open(args.dump, "wb") as f:
            pickle.dump(dump, f)
        print(f"dumped {len(dump)} sequences -> {args.dump}")
    return {"summary": agg, "per_seq": results, "traj": traj,
            "control_steps": steps, "seconds": seconds,
            "ms_per_step": 1e3 * seconds / max(steps, 1), "path": path,
            "agent": agent}


if __name__ == "__main__":
    main()
