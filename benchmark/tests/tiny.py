"""A throwaway copy of the benchmark's data files with a tiny traffic mix,
so that the CPU tests drive the harness end to end in seconds."""
from __future__ import annotations

import json
import os
import shutil

from benchmark import spec

TINY = {"kind": "train", "ranks": 1, "envs_per_rank": 6, "horizon": 4,
        "mini_batch_size": 8, "num_optim_epoch": 2}


def tiny_here(tmp, config="smpl24_implicit", ranks=1, limits=None,
              pcg_iters=5) -> str:
    """A directory laid out as benchmark/ (configs, traffic, metrics,
    limits) holding cell "tiny": `config` under the tiny mix, by default
    at the CPU's PCG-5 (the plain chain the agent runs off the card);
    `pcg_iters=None` keeps the configuration's own schedule."""
    here = os.path.join(str(tmp), "bench")
    shutil.rmtree(here, ignore_errors=True)
    for d in ("configs", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, d), os.path.join(here, d))
    os.makedirs(os.path.join(here, "traffic"))
    os.makedirs(os.path.join(here, "limits"))
    path = os.path.join(here, "configs", config + ".json")
    c = spec.load_json(path)
    if pcg_iters is not None:
        c["pcg_iters"] = pcg_iters
    with open(path, "w") as f:
        json.dump(c, f)
    with open(os.path.join(here, "traffic", "tiny.json"), "w") as f:
        json.dump({**TINY, "ranks": ranks}, f)
    if limits is not None:
        with open(os.path.join(here, "limits", "tiny.json"), "w") as f:
            json.dump({"numbers": limits}, f)
    return here


def tiny_bench(config="smpl24_implicit", chips=1) -> dict:
    bench = spec.benchmark_file()
    bench["workloads"] = [{"name": "tiny", "config": config,
                           "traffic": "tiny", "chips": chips, "why": "test"}]
    return bench


# limits for the tiny CPU cell, from its readings (float32 plain chain at
# PCG-5 against float64: physics_p90 0.1-0.23, no env far off, every
# other gap under 3e-6)
TINY_LIMITS = {"init_gap": {"limit": 0.0}, "physics_p90": {"limit": 2.0},
               "physics_far": {"limit": 0.0},
               "env_gap": {"limit": 1e-4}, "done_miss": {"limit": 0.0},
               "nets_gap": {"limit": 1e-4}, "gae_gap": {"limit": 1e-4},
               "ppo_loss_gap": {"limit": 1e-4},
               "ppo_grad_gap": {"limit": 1e-4},
               "ppo_change_gap": {"limit": 1e-3}}
