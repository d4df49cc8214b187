"""Training CLI (PyTorch twin of uhc_tpu.cli.train): PPO training of a
copycat controller on the stand-in humanoid.

Usage:
  python -m uhc_tpu_torch.cli.train [--cfg uhc_implicit]
      [--motion-file sample_data/gait_clips.pkl]
      [--num-envs 1024] [--horizon 48] [--epochs N] [--epoch N to resume]
      [--seed S] [--max-seq-len N] [--results-dir DIR] [--save-n-epochs N]
      [--no-train-eval] [--warm-start-from CKPT] [--device cpu]
      [--robot-model {smpl,smplh}] [--smpl-data SMPL.pkl]
      [--dr-variants N [--dr-friction-scale F] [--dr-contact-scale C]
      [--dr-mass-scale M]]

--cfg names a preset (`uhc_implicit`, `uhc_implicit_shape`) or a YAML
config `<name>.yml` in config/ or uhc_tpu_torch/config/: `explicit`
(explicit RFC) and `meta_joint` (per-joint meta-PD), which run through
K1f. The shape-conditioned preset gives every clip its own body from its
SMPL betas: from --smpl-data when given, else from synthetic blendshapes
(a loud warning says so). --dr-variants N >= 2 replicates every clip over N
contact- and mass-randomized models. --robot-model smplh trains on the
52-body SMPL-H humanoid (72-dof clips get flat hands) through K1d, the
big-tree kernel, or through K1f's big build with `--cfg explicit` or
`--cfg meta_joint`.

Runs on CUDA unless --device says otherwise; without a card it raises.
Each epoch logs `R= succ= eps= len= sps= T=`; scalars go to
<results-dir>/metrics.jsonl, checkpoints to <results-dir>/models/, and the
eval at each checkpoint to <results-dir>/eval_NNNN.json. UHC_TPU_LANE=0
routes the physics through K2 in place of K1, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def _positive_int(v):
    iv = int(v)
    if iv < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {iv}")
    return iv


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m uhc_tpu_torch.cli.train")
    p.add_argument("--cfg", default="uhc_implicit",
                   help="config preset (uhc_implicit, uhc_implicit_shape) "
                        "or <name>.yml in config/ or uhc_tpu_torch/config/ "
                        "(explicit, meta_joint)")
    p.add_argument("--motion-file", default="sample_data/gait_clips.pkl")
    p.add_argument("--num-envs", type=_positive_int, default=1024)
    p.add_argument("--horizon", type=_positive_int, default=48)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--epoch", type=int, default=0, help="resume epoch")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument("--results-dir", default=None,
                   help="default: results/<cfg>_torch")
    p.add_argument("--save-n-epochs", type=_positive_int, default=None,
                   help="override cfg.save_n_epochs (checkpoint/eval "
                        "cadence)")
    p.add_argument("--no-train-eval", action="store_true",
                   help="skip the eval at checkpoints")
    p.add_argument("--warm-start-from", default=None, metavar="CKPT",
                   help="initialize policy/value/obs-stats from another "
                        "run's checkpoint file (epoch counter and sampler "
                        "state start fresh)")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--robot-model", default=None, choices=("smpl", "smplh"),
                   help="override cfg robot.model (e.g. force the SMPL-H "
                        "52-body family on configs that lack the key)")
    p.add_argument("--smpl-data", default=None,
                   help="SMPL model pkl/npz for shape-conditioned training")
    p.add_argument("--dr-variants", type=int, default=0,
                   help="domain randomization: replicate every clip over N "
                        "models with scaled friction, contact stiffness / "
                        "damping and masses (variant 0 nominal)")
    p.add_argument("--dr-friction-scale", type=float, default=1.5)
    p.add_argument("--dr-contact-scale", type=float, default=2.0)
    p.add_argument("--dr-mass-scale", type=float, default=1.15)
    return p


def _logger(results_dir: str) -> logging.Logger:
    log = logging.getLogger(f"uhc_tpu_torch.train.{results_dir}")
    log.setLevel(logging.INFO)
    log.handlers.clear()
    log.propagate = False
    fmt = logging.Formatter("%(asctime)s %(message)s", "%H:%M:%S")
    for h in (logging.FileHandler(os.path.join(results_dir, "log.txt")),
              logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        log.addHandler(h)
    return log


def main(argv=None):
    """Train; returns (agent, per-epoch stats)."""
    p = parser()
    args = p.parse_args(argv)
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.device import resolve_device
    from uhc_tpu_torch.learn.agent import CopycatAgent
    from uhc_tpu_torch.utils.metrics_sink import MetricsSink

    device = resolve_device(args.device)
    if args.warm_start_from:
        if not os.path.isfile(args.warm_start_from):
            p.error(f"--warm-start-from: no such checkpoint: "
                    f"{args.warm_start_from}")
        if args.epoch > 0:
            p.error("--warm-start-from and --epoch (resume) are exclusive")
    try:
        cfg = Config.named(args.cfg)
    except ValueError as e:
        p.error(str(e))
    if args.robot_model is not None:
        import dataclasses

        cfg = dataclasses.replace(
            cfg, env=dataclasses.replace(cfg.env,
                                         robot_model=args.robot_model))
    agent = CopycatAgent(cfg, args.motion_file, num_envs=args.num_envs,
                         horizon=args.horizon, seed=args.seed,
                         max_seq_len=args.max_seq_len,
                         results_dir=args.results_dir, device=device,
                         smpl_data=args.smpl_data,
                         dr_variants=args.dr_variants,
                         dr_friction_scale=args.dr_friction_scale,
                         dr_contact_scale=args.dr_contact_scale,
                         dr_mass_scale=args.dr_mass_scale)
    log = _logger(agent.results_dir)
    log.info(f"cfg {cfg.cfg_id}: obs_dim={agent.obs_dim} "
             f"action_dim={agent.action_dim} seqs={len(agent.seq_keys)} "
             f"device={device}")
    if args.warm_start_from:
        agent.load_checkpoint_file(args.warm_start_from, warm_start=True)
        log.info(f"warm-started from {args.warm_start_from}")
    if args.epoch > 0:
        agent.load_checkpoint(args.epoch)

    sink = MetricsSink(agent.results_dir, resume=args.epoch > 0)
    epochs = args.epochs if args.epochs is not None else cfg.num_epoch
    save_n = (args.save_n_epochs if args.save_n_epochs is not None
              else cfg.save_n_epochs)
    history = []
    try:
        for i in range(args.epoch, epochs):
            stats = agent.optimize_policy(i)
            history.append(stats)
            sink.log(i, {k: v for k, v in stats.items()
                         if isinstance(v, (int, float))})
            log.info(f"epoch {i}: R={stats['reward_mean']:.4f} "
                     f"succ={stats['success_rate']:.3f} "
                     f"eps={int(stats['episodes'])} "
                     f"len={stats['avg_eps_len']:.1f} "
                     f"sps={stats['steps_per_sec']:.0f} "
                     f"T={stats['T_total']:.2f}s")
            if (i + 1) % save_n == 0 or i + 1 == epochs:
                agent.save_checkpoint(i + 1)
                log.info(f"saved checkpoint @ {i + 1}")
                if not args.no_train_eval:
                    s = agent.eval_policy()["summary"]
                    log.info(f"eval @ {i + 1}: coverage={s['coverage']}/"
                             f"{s['num_seqs']} succ={s['succ']:.3f} "
                             f"mpjpe={s['mpjpe']:.1f} "
                             f"mpjpe_g={s['mpjpe_g']:.1f}")
                    with open(os.path.join(agent.results_dir,
                                           f"eval_{i + 1:04d}.json"),
                              "w") as f:
                        json.dump(s, f, indent=1)
    finally:
        sink.close()
        for h in log.handlers:
            h.close()
    return agent, history


if __name__ == "__main__":
    main()
