"""The yardstick's counts (operations and bytes) and the published peaks
they are held against."""
from __future__ import annotations

import numpy as np

# one H100 SXM, NVIDIA's data sheet: float32 outside the tensor cores
# (TF32 is off in the port), HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def workload_flops(world, cell, contacts, envs: int, ranks: int,
                   minibatch: int, num_optim_epoch: int) -> dict:
    """One rank's counts for one epoch of the cell: the control step's
    operations and bytes (from the captured step's ground-contact sets,
    taken as every step's), and the epoch's operations: physics at every
    step, the policy and value forward on every rollout row, PPO's forward
    and backward (3x the forward) on this rank's share of every
    minibatch row of every pass."""
    from benchmark.counts import control_step as CS
    from benchmark.counts import nets as NF

    cfg, topo = world.cfg, world.topo
    T = int(cell.traffic["horizon"])
    step_flops = CS.control_step_flops(topo, cfg.env,
                                       [np.asarray(a) for a in contacts],
                                       world.pcg_iters)
    step_bytes = CS.control_step_bytes(topo, cfg.env, world.model, envs,
                                       world.pcg_iters)
    obs, act = cell.config["obs_dim"], cell.config["action_dim"]
    f_pol = NF.mcp_flops(obs, act, cfg.policy_hsize, cfg.composer_dim,
                         cfg.num_primitive)
    f_val = NF.value_flops(obs, cfg.value_hsize)
    N = T * envs * ranks
    n_mb = max(N // minibatch, 1)
    rows = num_optim_epoch * n_mb * min(minibatch, N) / ranks
    epoch = (T * step_flops + T * envs * f_pol + (T + 1) * envs * f_val
             + 3.0 * rows * (f_pol + f_val))
    return {"ctrl_flops_step": step_flops, "ctrl_bytes_step": step_bytes,
            "epoch_flops": epoch, "steps": T}
