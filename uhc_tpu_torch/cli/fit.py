"""Per-sequence fine-tuning CLI (PyTorch-port twin of uhc_tpu.cli.fit,
the reference's scripts/fit_uhc.py protocol).

Fine-tunes a policy, warm-started from a checkpoint, on one clip of a
motion file until it imitates it, then saves a per-sequence snapshot
<results-dir>/_singles/<key>.p {policy_params, value_params, log_std,
running_stats} in the JAX package's numpy layout (either package loads
it; cli/eval --singles-dir evaluates it).

Usage:
  python -m uhc_tpu_torch.cli.fit --key KEY [--cfg uhc_implicit]
      [--motion-file sample_data/gait_clips.pkl] [--epoch N]
      [--max-epochs 500] [--succ-threshold 0.95] [--window-criterion]
      [--eval-every 20] [--num-envs 512] [--horizon 48]
      [--results-dir DIR] [--device cpu]

Each epoch trains on the key alone (the sampler's logits pinned to it)
in precision mode (restarts near recorded failures). Once the windowed
training success reaches --succ-threshold, the whole sequence is
evaluated deterministically every --eval-every epochs and the loop stops
when the key succeeds there (--window-criterion stops at the threshold
instead). Logs go to <results-dir>/log/log.txt. Runs on CUDA unless
--device says otherwise.
"""
from __future__ import annotations

import argparse
import os
import pickle


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m uhc_tpu_torch.cli.fit")
    p.add_argument("--cfg", default="uhc_implicit",
                   help="config preset or <name>.yml, as cli/train")
    p.add_argument("--motion-file", default="sample_data/gait_clips.pkl")
    p.add_argument("--key", required=True)
    p.add_argument("--epoch", type=int, default=0, help="warm-start epoch")
    p.add_argument("--max-epochs", type=int, default=500)
    p.add_argument("--succ-threshold", type=float, default=0.95)
    p.add_argument("--window-criterion", action="store_true",
                   help="stop on the windowed training success alone, "
                        "without the full-sequence eval")
    p.add_argument("--eval-every", type=int, default=20,
                   help="full-sequence eval cadence once the windowed "
                        "threshold is reached")
    p.add_argument("--num-envs", type=int, default=512)
    p.add_argument("--horizon", type=int, default=48)
    p.add_argument("--results-dir", default=None,
                   help="checkpoint directory (default results/<cfg>_torch)")
    p.add_argument("--device", default=None, help="default: cuda")
    return p


def main(argv=None) -> dict:
    """Run the fit; returns {"agent", "path" (the snapshot), "history"
    (per-epoch stats), "evals" (epochs with a full-sequence eval),
    "last_eval" (the key's metrics at the last of them, or None)}."""
    import numpy as np

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.agent import CopycatAgent
    from uhc_tpu_torch.utils.logger import create_logger

    args = parser().parse_args(argv)
    agent = CopycatAgent(Config.named(args.cfg), args.motion_file,
                         num_envs=args.num_envs, horizon=args.horizon,
                         results_dir=args.results_dir, device=args.device)
    logger = create_logger(os.path.join(agent.results_dir, "log"))
    if args.epoch > 0:
        agent.load_checkpoint(args.epoch)
    if args.key not in agent.seq_keys:
        raise SystemExit(f"key {args.key!r} not in {agent.seq_keys}")
    # pin the sampler to this sequence (fit_single_key)
    logits = np.full(len(agent.seq_keys), -1e9, np.float32)
    logits[agent.seq_keys.index(args.key)] = 0.0
    agent.sampler.logits = lambda: logits
    agent.precision_mode = True

    singles = os.path.join(agent.results_dir, "_singles")
    os.makedirs(singles, exist_ok=True)
    history, evals, last_eval, m = [], [], None, None
    for i in range(args.epoch, args.epoch + args.max_epochs):
        stats = agent.optimize_policy(i)
        history.append(stats)
        succ = stats["success_rate"]
        logger.info(f"fit {args.key} epoch {i}: "
                    f"R={stats['reward_mean']:.4f} succ={succ:.3f}")
        if succ < args.succ_threshold:
            continue
        if args.window_criterion:
            logger.info(f"window success threshold reached at epoch {i}")
            break
        if last_eval is not None and i - last_eval < args.eval_every:
            continue
        last_eval = i
        evals.append(i)
        # track_best=False: the key's policy must not replace the shared
        # iter_best.p
        m = agent.eval_policy(track_best=False)["per_seq"][args.key]
        logger.info(f"full-seq eval at epoch {i}: succ={m['succ']:.0f} "
                    f"mpjpe={m['mpjpe']:.1f} root_dist={m['root_dist']:.1f}")
        if m["succ"] >= 1.0:
            logger.info(f"full-sequence success at epoch {i}")
            break
    path = os.path.join(singles, f"{args.key}.p")
    with open(path, "wb") as f:
        pickle.dump({"policy_params": nets.policy_to_numpy(agent.policy),
                     "value_params": nets.value_to_numpy(agent.value),
                     "log_std": agent.log_std.detach().cpu().numpy(),
                     "running_stats": RN.to_numpy(agent.rs)}, f)
    logger.info(f"saved {path}")
    return {"agent": agent, "path": path, "history": history,
            "evals": evals, "last_eval": m}


if __name__ == "__main__":
    main()
