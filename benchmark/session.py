"""One rank of a run: the copycat agent built as `cli/train.py` builds it,
a warm-up epoch at the cell's own shapes (set-up), the measured window of
whole epochs, with `--trace 1` one more epoch under torch.profiler, then
the correctness check against the reference."""
from __future__ import annotations

import dataclasses
import gc
import random
import shutil
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "uhc_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (`uhc_tpu_torch` is not `uhc_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_config(cell_config: dict, traffic: dict):
    """The program's Config of a configuration file, with the traffic
    mix's PPO settings where it states them."""
    from uhc_tpu_torch.config.config import Config

    cfg = Config.from_dict(cell_config["cfg_id"], cell_config["config"])
    over = {k: traffic[k] for k in ("mini_batch_size", "num_optim_epoch")
            if traffic.get(k) is not None}
    return dataclasses.replace(cfg, **over) if over else cfg


def _params(agent) -> dict:
    return {**{"policy." + k: p.detach().clone()
               for k, p in agent.policy.named_parameters()},
            **{"value." + k: p.detach().clone()
               for k, p in agent.value.named_parameters()}}


def run_rank(dist, cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, controls: bool = False) -> dict:
    """Run one rank of `cell` (a spec.Cell); `dist` is the program's
    data-parallel handle or None. Returns plain numbers for the caller.
    With `controls`, also the numbers of the control and of each planted
    fault (benchmark/control.py), which the benchmark's runs never
    compute."""
    import torch

    from benchmark import check as C
    from benchmark.probes import Probe
    from benchmark.reference import world as W
    from uhc_tpu_torch.learn.agent import CopycatAgent

    tr = cell.traffic
    ranks = 1 if dist is None else dist.world_size
    rank = 0 if dist is None else dist.rank
    dev = torch.device(device) if dist is None else dist.device
    cuda = dev.type == "cuda"
    cfg = program_config(cell.config, tr)
    horizon, envs = int(tr["horizon"]), int(tr["envs_per_rank"])
    rng = random.Random(seed)
    probe = Probe(capture_step=rng.randrange(horizon))
    probe.ppo_epoch, probe.env_epoch = 0, 1
    results = tempfile.mkdtemp(prefix="bench_results_")
    out = {"rank": rank}
    try:
        with probe.installed():
            agent = CopycatAgent(cfg, cell.config["motion_file"],
                                 num_envs=envs * ranks, horizon=horizon,
                                 seed=seed, results_dir=results, device=dev,
                                 dist=dist)
            probe.attach(agent)
            init = _params(agent)
            agent.optimize_policy(0)                    # warm-up
            rollout_params = _params(agent)
            if cuda:
                torch.cuda.synchronize(dev)
            probe.record_steps, probe.count_steps = cuda, True
            t_window = time.time()
            t0 = time.perf_counter()
            stats, i = [], 1
            while True:
                stats.append(agent.optimize_policy(i))
                i += 1
                stop = time.perf_counter() - t0 >= seconds
                if dist is not None:
                    import torch.distributed as D

                    flag = torch.tensor([float(stop)], device=dev)
                    D.broadcast(flag, 0)
                    stop = bool(flag.item())
                if stop:
                    break
            window_s = time.perf_counter() - t0
            probe.record_steps = probe.count_steps = False
            out.update(window_s=window_s, t_window=t_window,
                       setup_s=t_window - t_start, epochs=len(stats),
                       env_steps=probe.env_steps,
                       blown=0 if probe.blown is None else int(probe.blown),
                       step_ms=probe.step_ms() if cuda else [],
                       stats=[{k: v for k, v in s.items()
                               if isinstance(v, (int, float))}
                              for s in stats])
            if trace:
                from benchmark import trace as T

                out["trace"] = T.profile_epoch(agent, probe, i, dev)
            if cuda:
                torch.cuda.synchronize(dev)
                out["memory_peak_bytes"] = int(
                    torch.cuda.max_memory_allocated(dev))
            cap = probe.cap
            cap.update(clip=cfg.clip_epsilon, obs_dim=agent.obs_dim,
                       action_dim=agent.action_dim,
                       params_at_rollout=(
                           {k[7:]: v for k, v in rollout_params.items()
                            if k.startswith("policy.")},
                           {k[6:]: v for k, v in rollout_params.items()
                            if k.startswith("value.")}))
            minibatch, n_opt = agent.minibatch, cfg.num_optim_epoch
            del agent, stats
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        comm = C.Comm(ranks, rank)
        glob = C.gather(cap, comm, envs, horizon, minibatch, n_opt)
        world = W.build(cell.config, dev, torch.float64)
        contacts = []
        ref = C.reference_outputs(world, cap, glob, seed, comm,
                                  trace=contacts)
        prog = C.program_outputs(cap, glob, init)
        ppo0 = {**{"value." + k: v for k, v in cap["ppo"]["value0"].items()},
                **{"policy." + k: v
                   for k, v in cap["ppo"]["policy0"].items()}}
        thresh = world.cfg.env.body_diff_thresh
        out["numbers"] = C.numbers(prog, ref, ppo0, glob, thresh,
                                   tails=controls)
        if controls:
            out.update(control_numbers(world, cap, glob, seed, comm, ref,
                                       ppo0, thresh))
        if trace:
            from benchmark.counts import workload_flops

            out["trace"].update(workload_flops(
                world, cell, contacts, envs, ranks, minibatch, n_opt))
    finally:
        shutil.rmtree(results, ignore_errors=True)
    # last: what the window, the reference and the counts loaded
    out["modules"] = forbidden_modules()
    return out


def control_numbers(world, cap, glob, seed, comm, ref, ppo0,
                    thresh) -> dict:
    """The numbers of the control, the reference put in the program's
    place one precision below the configuration's (float32 with TF32 on,
    for float32 with TF32 off), and of each fault planted in the
    reference put in its place at float32 (benchmark/check.py
    `reference_outputs`)."""
    import torch

    from benchmark import check as C
    from benchmark.reference import world as W

    w32 = W.as_dtype(world, torch.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctl = C.reference_outputs(w32, cap, glob, seed, comm)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    faults = ["unchanged", "last_envs", "half_batch", "altered"] + (
        ["no_exchange"] if comm.world > 1 else [])
    return {"control": C.numbers(ctl, ref, ppo0, glob, thresh, tails=True),
            "faults": {f: C.numbers(C.reference_outputs(
                w32, cap, glob, seed, comm, fault=f), ref, ppo0, glob,
                thresh, tails=True) for f in faults}}


def rank_entry(dist, cell, seed, seconds, trace, t_start, controls=False):
    """The data-parallel ranks' entry (pickled by the program's spawn)."""
    return run_rank(dist, cell, seed, seconds, trace, t_start,
                    controls=controls)
