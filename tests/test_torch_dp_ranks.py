"""Rank functions of the data-parallel tests (no tests here, no JAX): each
runs in a process spawned by `uhc_tpu_torch.learn.data_parallel.spawn`,
which imports this module by name, and returns numpy arrays for the test
process to hold against the single-process port and the JAX package.

The global batches are made from seeds with numpy, alike on every rank;
rank r takes the envs (columns) [r·B, (r+1)·B) of a (T, W·B) batch."""
import dataclasses
import time

import numpy as np
import torch

from test_torch_helpers import host_sync_sites

# the PPO batch: T steps × W·B envs, D obs dims, A actions
T, B, D, A = 4, 6, 12, 5
# the running-statistics batches: three of rows per rank, D dims
RN_ROWS, RN_DIM = (5, 9, 4), 7
LR_P, LR_V, PASSES = 5e-5, 3e-4, 3


def rank_columns(x, rank: int, envs: int):
    """Rank `rank`'s part of a (T, W·envs, ...) array, (T·envs, ...)."""
    part = x[:, rank * envs:(rank + 1) * envs]
    return np.ascontiguousarray(part.reshape(-1, *x.shape[2:]))


def rn_batches(masked: bool, world: int, dtype):
    """Per batch, (x, mask) for every rank: seeded rows around 3·N(0, 1) +
    i; masked, rank 1 holds no masked row in the second batch."""
    rng = np.random.default_rng(11)
    out = []
    for i, n in enumerate(RN_ROWS):
        xs = [(3.0 * rng.standard_normal((n + r, RN_DIM)) + i).astype(dtype)
              for r in range(world)]
        ms = [rng.random(n + r) < 0.6 if masked else None
              for r in range(world)]
        if masked and world > 1:
            ms[1] = np.zeros_like(ms[1]) if i == 1 else ms[1]
        out.append((xs, ms))
    return out


def gae_inputs(world: int, dtype):
    """(rewards, masks, values, bootstrap) of (T, W·B) envs."""
    rng = np.random.default_rng(12)
    Bg = world * B
    return (rng.random((T, Bg)).astype(dtype),
            (rng.random((T, Bg)) > 0.15).astype(dtype),
            rng.standard_normal((T, Bg)).astype(dtype),
            rng.standard_normal(Bg).astype(dtype))


def ppo_batch(world: int, dtype):
    """The (T, W·B) global PPO batch, flattened time-major like the
    agent's: advantages large enough that the clip is exercised."""
    rng = np.random.default_rng(13)
    Bg = world * B
    return {"states": rng.standard_normal((T, Bg, D)).astype(dtype),
            "actions": (0.3 * rng.standard_normal((T, Bg, A))).astype(dtype),
            "advantages": (10.0 * rng.standard_normal((T, Bg))).astype(dtype),
            "returns": (2.0 + rng.standard_normal((T, Bg))).astype(dtype),
            "exps": (rng.random((T, Bg)) < 0.7).astype(dtype)}


def small_nets(dtype=torch.float32):
    """The MCP policy and value net of tests/test_torch_train.py, seeded."""
    from uhc_tpu_torch.learn import nets

    gen = torch.Generator().manual_seed(4)
    pol = nets.policy_mcp_init(D, A, (16, 8), (8, 4), 3, gen, "relu", "cpu")
    val = nets.value_init(D, (16, 8), gen, "relu", "cpu")
    return pol.to(dtype), val.to(dtype)


def ppo_run(batch, fix_std: bool, minibatch: int, dtype, dist=None,
            envs=None):
    """One PPO update of the small nets (Adam, PASSES passes, generator
    seeded 0) on `batch` {key: (N, ...) array}: ppo_update alone, or
    ppo_update_dist as one rank of `dist`. -> (policy, value, log_std,
    stats) as numpy."""
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.ppo import ppo_update, ppo_update_dist

    tdt = torch_dtype(dtype)
    pol, val = small_nets(tdt)
    log_std = torch.full((A,), -2.3, dtype=tdt)
    log_std_opt = None
    if not fix_std:
        log_std.requires_grad_()
        log_std_opt = torch.optim.Adam([log_std], lr=LR_P)
    popt = torch.optim.Adam(pol.parameters(), lr=LR_P)
    vopt = torch.optim.Adam(val.parameters(), lr=LR_V)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    if dist is None:
        stats = ppo_update(pol, val, popt, vopt, log_std, tb, gen, 0.2,
                           PASSES, minibatch, log_std_opt=log_std_opt)
    else:
        stats = ppo_update_dist(pol, val, popt, vopt, log_std, tb, gen, 0.2,
                                PASSES, minibatch, dist, envs,
                                log_std_opt=log_std_opt)
    return (nets.policy_to_numpy(pol), nets.value_to_numpy(val),
            log_std.detach().numpy(),
            {k: float(v) for k, v in stats.items()})


PPO_CASES = {  # name -> (fix_std, minibatch, dtype)
    "f64_fix_std": (True, 4, np.float64),
    "f64_trainable_std": (False, 4, np.float64),
    "f32_fix_std": (True, T * 2 * B, np.float32),
    "f32_trainable_std": (False, T * 2 * B, np.float32)}


def torch_dtype(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def rn_init(dtype):
    from uhc_tpu_torch.learn import running_norm as RN

    rs = RN.init(RN_DIM, "cpu")
    return RN.RunningStats(*(t.to(torch_dtype(dtype))
                             for t in (rs.n, rs.mean, rs.m2)))


def pieces_rank(d):
    """Running statistics, whitening and PPO as one rank: each on this
    rank's part of the seeded global inputs."""
    from uhc_tpu_torch.learn import running_norm as RN
    from uhc_tpu_torch.learn.gae import estimate_advantages

    torch.set_num_threads(2)
    out = {"rn": {}, "gae": {}, "ppo": {}}
    for masked in (False, True):
        for dtype in (np.float32, np.float64):
            rs = rn_init(dtype)
            for xs, ms in rn_batches(masked, d.world_size, dtype):
                m = ms[d.rank]
                rs = RN.update_batch(rs, torch.tensor(xs[d.rank]),
                                     None if m is None else torch.tensor(m),
                                     dist=d)
            out["rn"][masked, np.dtype(dtype).name] = RN.to_numpy(rs)
    for dtype in (np.float32, np.float64):
        r, m, v, boot = gae_inputs(d.world_size, dtype)
        cols = slice(d.rank * B, (d.rank + 1) * B)
        adv, ret = estimate_advantages(
            *(torch.tensor(np.ascontiguousarray(x[..., cols]))
              for x in (r, m, v, boot)), 0.95, 0.95, dist=d)
        out["gae"][np.dtype(dtype).name] = (adv.numpy(), ret.numpy())
    for name, (fix_std, mb, dtype) in PPO_CASES.items():
        batch = {k: rank_columns(x, d.rank, B)
                 for k, x in ppo_batch(d.world_size, dtype).items()}
        out["ppo"][name] = ppo_run(batch, fix_std, mb, dtype, d, B)
    return out


def slow_rank0(d, seconds: float):
    """Rank 0 works `seconds` with no collective (as through a checkpoint
    and an eval) while the others wait in Dist.barrier; then a sum of ones
    over the ranks."""
    if d.rank == 0:
        time.sleep(seconds)
    d.barrier()
    return float(d.all_reduce(torch.ones(1, device=d.device)).item())


# -- the agent ---------------------------------------------------------------
GAIT = "sample_data/gait_clips.pkl"
ENVS, HORIZON, MAX_LEN = 4, 3, 20
# the exploring run's clips: short enough that episodes end in 2 epochs
RUN_LEN = 6


def agent_cfg(explore: bool = True):
    """A narrow uhc_implicit (MCP 3 × (784 → 32 → 16 → 75), value 32 →
    16), one minibatch a pass, two passes; `explore` False: every action
    the mean."""
    from uhc_tpu_torch.config.config import Config

    return dataclasses.replace(
        Config.uhc_implicit(), policy_hsize=(32, 16), composer_dim=(16, 8),
        num_primitive=3, value_hsize=(32, 16), mini_batch_size=4096,
        num_optim_epoch=2,
        **({} if explore else {"adp_noise_rate_cp": (0.0,)}))


def agent(cfg, out, dist=None, max_len=MAX_LEN):
    from uhc_tpu_torch.learn.agent import CopycatAgent

    return CopycatAgent(cfg, GAIT, num_envs=ENVS, horizon=HORIZON, seed=3,
                        max_seq_len=max_len, results_dir=out, device="cpu",
                        dist=dist)


def fixed_states(a, num_envs=ENVS):
    """`num_envs` training resets alike on every process (env i: seq i
    mod S at frame 2 + 3i, joint noise 0.05 from a seeded generator, no
    done), for a rollout in which no env ends."""
    from uhc_tpu_torch.envs import humanoid_im as H

    S = len(a.seq_keys)
    seq = torch.arange(num_envs) % S
    env_cfg = dataclasses.replace(a.env_cfg, env_init_noise=0.05)
    st = H.env_reset(a.topo, a.sim_model, env_cfg, seq, a.expert_lib,
                     a.aux["neutral_qpos"], a.aux["neutral_qvel"],
                     start_ind=2 + 3 * torch.arange(num_envs), train=True,
                     generator=torch.Generator().manual_seed(0))
    return dataclasses.replace(st, done=torch.zeros(num_envs,
                                                    dtype=torch.bool))


def warm_stats(dim: int):
    """Running statistics as after a warm start, alike on every process:
    50 seeded rows' worth (mean N(0, 1), variance 0.5 to 1.5). Some 60 obs
    dims of the gait clips are constant over clips and frames; from cold
    statistics their spread is float32 rounding noise, which the
    normalization divides by, so one path's rounding against another's
    gives O(1) differences there. A prior spread keeps them defined."""
    from uhc_tpu_torch.learn import running_norm as RN

    rng = np.random.default_rng(14)
    n = 50.0
    return RN.from_numpy({"n": n, "mean": rng.standard_normal(dim),
                          "m2": n * (0.5 + rng.random(dim))}, "cpu")


def take_envs(state, rank: int, envs: int):
    """Rank `rank`'s envs of a global EnvState."""
    return type(state)(**{
        f.name: (getattr(state, f.name)[rank * envs:(rank + 1) * envs]
                 if torch.is_tensor(getattr(state, f.name))
                 and getattr(state, f.name).ndim > 0
                 else getattr(state, f.name))
        for f in dataclasses.fields(state)})


def snapshot(a) -> dict:
    from uhc_tpu_torch.learn import nets, running_norm as RN

    return {"policy": nets.policy_to_numpy(a.policy),
            "value": nets.value_to_numpy(a.value),
            "log_std": a.log_std.detach().numpy().copy(),
            "rs": RN.to_numpy(a.rs)}


def agent_rank(d, out):
    """(1) one epoch with exploration off from fixed states and warm
    statistics; (2) two
    epochs of the exploring config, rank 0's checkpoint, a resume on every
    rank from it and one more epoch; returns what the test compares."""
    torch.set_num_threads(2)
    res = {}
    a = agent(agent_cfg(explore=False), f"{out}/still", d)
    a.rs = warm_stats(a.obs_dim)
    a.env_states = take_envs(fixed_states(a), d.rank, a.local_envs)
    with host_sync_sites() as sites:
        st = a.optimize_policy(0)
    res["still"] = {"stats": st, **snapshot(a),
                    "dones": int(st["episodes"]), "host_sync": sites,
                    "obs_dim": a.obs_dim, "minibatch": a.minibatch,
                    "params": [p.numel() for p in (
                        *a.policy.parameters(), *a.value.parameters())]}

    a = agent(agent_cfg(), f"{out}/run", d, RUN_LEN)
    hist = [a.optimize_policy(i) for i in range(2)]
    probe = np.random.default_rng(5).standard_normal(
        (6, a.obs_dim)).astype(np.float32)
    with torch.no_grad():
        mean = a.policy(torch.tensor(probe)).numpy()
    if d.rank == 0:
        a.save_checkpoint(2)
    d.barrier()
    b = agent(agent_cfg(), f"{out}/run", d, RUN_LEN)
    b.load_checkpoint(2)
    loaded = b.replica_digest()
    b.optimize_policy(2)
    res["run"] = {"digests": a.replica_digests, "loaded": loaded,
                  "resumed": b.replica_digests, "probe": probe,
                  "mean": mean, "hist": hist,
                  "episodes": sum(h["episodes"] for h in hist)}
    return res
