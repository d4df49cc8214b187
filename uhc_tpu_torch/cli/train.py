"""Training CLI (PyTorch twin of uhc_tpu.cli.train): PPO training of a
copycat controller on the stand-in humanoid, or (`--agent uhm`) of a
kinematic policy over a frozen copycat.

Usage:
  python -m uhc_tpu_torch.cli.train [--cfg uhc_implicit]
      [--motion-file sample_data/gait_clips.pkl]
      [--num-envs 1024] [--horizon 48] [--epochs N] [--epoch N to resume]
      [--seed S] [--max-seq-len N] [--results-dir DIR] [--save-n-epochs N]
      [--no-train-eval] [--warm-start-from CKPT] [--device cpu]
      [--data-parallel] [--profile DIR]
      [--robot-model {smpl,smplh}] [--smpl-data SMPL.pkl]
      [--dr-variants N [--dr-friction-scale F] [--dr-contact-scale C]
      [--dr-mass-scale M]]
  python -m uhc_tpu_torch.cli.train --cfg uhm_1 --agent uhm
      [--cc-checkpoint results/uhc_implicit/models/iter_best.p]
      [--num-envs 256] [--horizon 24] [--epochs N] ...

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

--data-parallel trains one copycat over every visible card, one rank a
card over NCCL (learn/data_parallel.py): --num-envs is the global count,
split evenly, and the run computes what one process over all the envs
computes. Rank 0 alone logs, writes metrics.jsonl, checkpoints and the
eval; the others wait for it with no time limit (a collective alone times
out, after 30 min). With one card, or with --device cpu, it runs the
single-process path and says so (the JAX rule: a mesh only over more than
one device). With --agent uhm it refuses (the JAX CLI builds a mesh there
and never passes it on). --profile DIR writes a torch.profiler trace (CPU
and CUDA activity, Chrome trace format) of epochs epoch+2 to epoch+4 to
DIR/trace.json, each epoch a span "epoch N"; under --data-parallel rank 0
writes it.

--agent uhm (`learn.agent_uhm.UHMAgent`, with --cfg uhm_1, the preset of
config/uhm_1.yml) trains the kinematic policy through the kin env: the
frozen copycat of --cc-checkpoint (a seeded one without it) tracks the
policy's integrated targets on the exact chain (no kernel, as in the JAX
package), PPO over the rollout and a supervised epoch on GT windows per
epoch, as its policy_specs say. It logs `R= sup= T=`, keeps checkpoints
in <results-dir>/models/ (default results/uhm_<cfg>_torch), and runs no
eval at checkpoints (cli/eval_relive does).
"""
from __future__ import annotations

import argparse
import contextlib
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
                   help="config preset (uhc_implicit, uhc_implicit_shape, "
                        "uhm_1) "
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
    p.add_argument("--agent", choices=("copycat", "uhm"), default="copycat",
                   help="copycat controller, or the kinematic policy (UHM)")
    p.add_argument("--cc-checkpoint", default=None,
                   help="frozen copycat checkpoint for --agent uhm")
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank per visible card over NCCL; --num-envs "
                        "is the global count; a collective times out after "
                        "30 min, the run and rank 0's checkpoint eval have "
                        "no limit")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="torch.profiler trace of epochs epoch+2 to epoch+4 "
                        "into DIR/trace.json")
    return p


def _logger(results_dir: str, quiet: bool = False) -> logging.Logger:
    """The run's logger: log.txt and stdout, or nothing when `quiet` (a
    data-parallel rank other than 0)."""
    log = logging.getLogger(f"uhc_tpu_torch.train.{results_dir}")
    log.setLevel(logging.INFO)
    log.handlers.clear()
    log.propagate = False
    fmt = logging.Formatter("%(asctime)s %(message)s", "%H:%M:%S")
    handlers = ([logging.NullHandler()] if quiet else
                [logging.FileHandler(os.path.join(results_dir, "log.txt")),
                 logging.StreamHandler(sys.stdout)])
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    return log


def main(argv=None):
    """Train; returns (agent, per-epoch stats). Under --data-parallel on
    more than one card: (None, each rank's {"history", "digests",
    "launches"}: its per-epoch stats, replica digests and kernel launch
    counts)."""
    p = parser()
    args = p.parse_args(argv)
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.warm_start_from:
        if not os.path.isfile(args.warm_start_from):
            p.error(f"--warm-start-from: no such checkpoint: "
                    f"{args.warm_start_from}")
        if args.epoch > 0:
            p.error("--warm-start-from and --epoch (resume) are exclusive")
    if args.data_parallel and args.agent == "uhm":
        p.error("--data-parallel trains the copycat only (--agent uhm has "
                "no data-parallel path)")
    try:
        Config.named(args.cfg)
    except ValueError as e:
        p.error(str(e))
    ranks = 1
    if args.data_parallel and device.type == "cuda":
        import torch

        ranks = torch.cuda.device_count()
    if ranks > 1:
        from uhc_tpu_torch.learn import data_parallel

        return None, data_parallel.spawn(_rank_main, ranks, "cuda", "nccl",
                                         args=(args,))
    return run(args, device)


def _rank_main(d, args):
    """One rank of `--data-parallel`: the run, then what the caller
    checks (per-epoch stats, replica digests, kernel launch counts)."""
    from uhc_tpu_torch.physics import control_step as CS

    agent, history = run(args, d.device, d)
    return {"history": history, "digests": agent.replica_digests,
            "launches": dict(CS.LAUNCHES)}


def run(args, device, dist=None):
    """The training run of parsed `args` on `device`, as one rank of
    `dist` (learn/data_parallel.Dist) or alone; returns (agent, per-epoch
    stats)."""
    import torch

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn.agent import CopycatAgent
    from uhc_tpu_torch.utils.metrics_sink import MetricsSink

    lead = dist is None or dist.rank == 0
    cfg = Config.named(args.cfg)
    if args.robot_model is not None:
        import dataclasses

        cfg = dataclasses.replace(
            cfg, env=dataclasses.replace(cfg.env,
                                         robot_model=args.robot_model))
    uhm = args.agent == "uhm"
    if uhm:
        from uhc_tpu_torch.learn.agent_uhm import UHMAgent

        agent = UHMAgent(cfg, args.motion_file,
                         cc_checkpoint_path=args.cc_checkpoint,
                         num_envs=args.num_envs, horizon=args.horizon,
                         seed=cfg.seed if args.seed is None else args.seed,
                         max_seq_len=args.max_seq_len,
                         results_dir=args.results_dir, device=device)
    else:
        agent = CopycatAgent(cfg, args.motion_file, num_envs=args.num_envs,
                             horizon=args.horizon, seed=args.seed,
                             max_seq_len=args.max_seq_len,
                             results_dir=args.results_dir, device=device,
                             smpl_data=args.smpl_data,
                             dr_variants=args.dr_variants,
                             dr_friction_scale=args.dr_friction_scale,
                             dr_contact_scale=args.dr_contact_scale,
                             dr_mass_scale=args.dr_mass_scale, dist=dist)
    log = _logger(agent.results_dir, quiet=not lead)
    if uhm:
        from uhc_tpu_torch.learn.kin_net import kin_obs_dim

        log.info(f"cfg {cfg.cfg_id}: agent uhm, kin obs_dim="
                 f"{kin_obs_dim(agent.topo)} cc obs_dim={agent.cc_obs_dim} "
                 f"cc action_dim={agent.cc_action_dim} "
                 f"seqs={len(agent.seq_keys)} device={device}")
    else:
        log.info(f"cfg {cfg.cfg_id}: obs_dim={agent.obs_dim} "
                 f"action_dim={agent.action_dim} seqs={len(agent.seq_keys)} "
                 f"device={device}")
    if dist is not None:
        import torch.distributed as D

        log.info(f"data-parallel: {dist.world_size} ranks, "
                 f"{agent.local_envs} envs each, over {D.get_backend()} "
                 f"(rank 0 on {device})")
    elif args.data_parallel:
        log.info(f"--data-parallel: one device ({device}), the "
                 f"single-process path")
    if args.warm_start_from:
        agent.load_checkpoint_file(args.warm_start_from, warm_start=True)
        log.info(f"warm-started from {args.warm_start_from}")
    if args.epoch > 0:
        agent.load_checkpoint(args.epoch)

    sink = (MetricsSink(agent.results_dir, resume=args.epoch > 0)
            if lead else None)
    epochs = args.epochs if args.epochs is not None else cfg.num_epoch
    if uhm:
        # the gt_rate anneal runs over the planned epochs, as in JAX
        agent.total_epochs = epochs
    save_n = (args.save_n_epochs if args.save_n_epochs is not None
              else cfg.save_n_epochs)
    history = []
    prof = (_profiler(args.profile, args.epoch, device, log)
            if args.profile and lead else None)
    try:
        with prof or contextlib.nullcontext():
            for i in range(args.epoch, epochs):
                with torch.profiler.record_function(f"epoch {i}"):
                    stats = agent.optimize_policy(i)
                if prof is not None:
                    prof.step()
                history.append(stats)
                if not lead:
                    if (i + 1) % save_n == 0 or i + 1 == epochs:
                        dist.barrier()     # rank 0's checkpoint and eval
                    continue
                sink.log(i, {k: v for k, v in stats.items()
                             if isinstance(v, (int, float))})
                if uhm:
                    log.info(" ".join(
                        [f"epoch {i}:"]
                        + ([f"R={stats['reward_mean']:.4f}"]
                           if "reward_mean" in stats else [])
                        + ([f"sup={stats['supervised_loss']:.4f}"]
                           if "supervised_loss" in stats else [])
                        + [f"T={stats['T_total']:.2f}s"]))
                else:
                    log.info(f"epoch {i}: R={stats['reward_mean']:.4f} "
                             f"succ={stats['success_rate']:.3f} "
                             f"eps={int(stats['episodes'])} "
                             f"len={stats['avg_eps_len']:.1f} "
                             f"sps={stats['steps_per_sec']:.0f} "
                             f"T={stats['T_total']:.2f}s")
                if (i + 1) % save_n == 0 or i + 1 == epochs:
                    agent.save_checkpoint(i + 1)
                    log.info(f"saved checkpoint @ {i + 1}")
                    if not uhm and not args.no_train_eval:
                        s = agent.eval_policy()["summary"]
                        log.info(f"eval @ {i + 1}: coverage={s['coverage']}/"
                                 f"{s['num_seqs']} succ={s['succ']:.3f} "
                                 f"mpjpe={s['mpjpe']:.1f} "
                                 f"mpjpe_g={s['mpjpe_g']:.1f}")
                        with open(os.path.join(agent.results_dir,
                                               f"eval_{i + 1:04d}.json"),
                                  "w") as f:
                            json.dump(s, f, indent=1)
                    if dist is not None:
                        dist.barrier()
    finally:
        if sink is not None:
            sink.close()
        for h in log.handlers:
            h.close()
    return agent, history


def _profiler(directory: str, first: int, device, log):
    """A torch.profiler over the epochs from `first`, stepped once an
    epoch, that records epochs first+2 to first+4 (the JAX CLI's window)
    and exports them to DIR/trace.json when the window ends or the run
    does. It starts at first+1, whose record it drops, so that the
    tracer's own start-up falls outside the window."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(directory, "trace.json")

    def export(prof):
        os.makedirs(directory, exist_ok=True)
        prof.export_chrome_trace(path)
        log.info(f"profiler trace (epochs {first + 2}-"
                 f"{first + prof.step_num - 1}) -> {path}")

    return torch.profiler.profile(
        activities=acts, on_trace_ready=export,
        schedule=torch.profiler.schedule(skip_first=1, wait=0, warmup=1,
                                         active=3, repeat=1))


if __name__ == "__main__":
    main()
