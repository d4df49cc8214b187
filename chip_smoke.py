#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (uhc_tpu_torch) runs on an NVIDIA
H100: builds every hand-written kernel from this checkout (K1, the
one-launch control step, K2, its head/tail split, K1e / K2 over a per-env
model library, and K1d, the same kernels built for the 52-body SMPL-H and
the 48-body masterfoot trees; one nvcc per tree, all at once), holds each
against its plain PyTorch version on the card, drives the main paths at
full width with seeded weights -- closed-loop copycat evaluation of every
clip of sample_data/gait_clips.pkl through K1, PPO training through
cli/train with 1024 envs × 48 steps, through K1 (default routing) and
through K2 (UHC_TPU_LANE=0), the shape-conditioned uhc_implicit_shape
config over the 8 bodies of sample_data/shape_clips.pkl (eval through K1e,
training through K1e and K2 over the library), domain-randomized training
through K1e, and training on the big trees: `cli/train --robot-model
smplh` with 512 envs × 32 steps through K1d with the eval at the
checkpoint, then through K2 (UHC_TPU_LANE_BIG=0), and the masterfoot
agent (env.masterfoot) through K1d and K2, and K1f, the control step with
explicit residual force control or per-joint meta-PD, held against its
plain version in five modes, in the closed-loop eval of the gait clips
under the `explicit` config and in training under `explicit` and
`meta_joint` (uhc_tpu_torch/config/), K1f on the big trees (both configs
on SMPL-H and on masterfoot, held against its plain versions, and in
training there, `cli/train --cfg explicit --robot-model smplh` with the
eval at the checkpoint), and K1g, the control step with a second exact
inverse pair at substep 8 (`refresh_at`), held against its plain versions
and a PCG-8 step on the 24-body tree and on SMPL-H and run as bench.py
runs its control steps -- checks their output, and times the kernels at
B=2048 (and the big trees' at B=512).

Usage: python3 chip_smoke.py        (needs one CUDA card; no arguments)

Phases print a line when they start and one with their numbers when they
end. Output ends with a JSON line of per-kernel numbers, the card's name
and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}} as the last line. Any failure, a missing
card, a missing repository or the deadline exits non-zero and prints no
result.
"""
import json
import os
import signal
import subprocess
import sys
import time
import traceback

DEADLINE_S = 900
H100_F32_FLOPS = 67e12      # float32 outside the tensor cores (data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3
# kernel vs plain, one control step: the bounds of tests/test_fused_split.py
QPOS_TOL, QVEL_TOL = 1e-5, 1e-3
# K2's head: Xp, Xf vs the float64 plain exact inverses, relative to the
# largest entry of each matrix. Both factor in float32 (rounding about
# cond(A)·2⁻²⁴); the host build of the same source reads 2.3e-5
# (tests/test_torch_control_step_split.py).
X_REL_TOL = 1e-4
B_CHECK, B_TIME = 256, 2048
TRAIN_ARGS = ["--num-envs", "1024", "--horizon", "48", "--no-train-eval"]
SHAPE_CLIPS = "sample_data/shape_clips.pkl"
# the shape run of the JAX package (tools/train_queue.sh:36-38)
SHAPE_TRAIN_ARGS = ["--cfg", "uhc_implicit_shape", "--motion-file",
                    SHAPE_CLIPS, "--num-envs", "1024", "--horizon", "32",
                    "--no-train-eval"]
DR_TRAIN_ARGS = TRAIN_ARGS + ["--dr-variants", "4"]
# the kernel builds: the 24-body humanoid, masterfoot, SMPL-H
BODIES = (24, 48, 52)
BIG = (("smplh", 52), ("masterfoot", 48))
# the JAX package's SMPL-H run (tools/train_queue.sh:39-42)
SMPLH_TRAIN_ARGS = ["--robot-model", "smplh", "--num-envs", "512",
                    "--horizon", "32"]
B_BIG_TIME = (2048, 512)
# K1f's states: this share of the envs lowered by 2 cm, so that ground
# contacts are active and the "ground" gate is not vacuous
# (tests/test_fused_split.py:512)
K1F_LOWERED, K1F_SINK = 4, 0.02
# K1f's modes on the big trees (phase k1f_big)
K1F_BIG_MODES = ("explicit", "explicit_ground", "meta_joint")
# K1g: the refresh substep and schedules of tests/test_fused_split.py:214-224
# (PCG (1, 1) on 24 bodies; the big trees keep their (2, 2)), held against
# a PCG-8 step at its bounds
REFRESH_AT, PCG8 = 8, (8, 8)
SCHED_QPOS_TOL, SCHED_QVEL_TOL = 2e-3, 0.2
# the control steps of phase k1g's bench.py-style run (bench.py
# _make_run: the state fed back, the actions held)
K1G_CHAIN = 15

_phase = ["start"]
TRAIN_RATES = {}     # phase -> per-epoch rollout rates and PPO times


class Deadline(Exception):
    pass


def _on_alarm(signum, frame):
    raise Deadline(f"deadline of {DEADLINE_S} s passed")


def phase(name: str, detail: str = "") -> None:
    _phase[0] = name
    print(f"phase {name} {detail}".rstrip(), flush=True)


def done(name: str, **numbers) -> None:
    print(f"phase {name} done " + json.dumps(numbers), flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def draw_states(lib, B, gen, dev):
    """The state recipe of tests/test_fused_split.py, over clip frames:
    expert qpos, seeded qvel noise (0.05), next frame's joints as the PD
    base; returns (qpos, qvel, target_base)."""
    import torch

    S = lib["qpos"].shape[0]
    si = torch.randint(0, S, (B,), generator=gen).to(dev)
    ti = torch.randint(0, int(lib["len"].min()) - 1, (B,),
                       generator=gen).to(dev)
    qvel = 0.05 * torch.randn((B, 75), generator=gen).to(dev)
    return (lib["qpos"][si, ti].contiguous(), qvel.contiguous(),
            lib["qpos"][si, ti + 1, 7:].contiguous())


def double_model(model):
    import dataclasses

    return type(model)(**{f.name: getattr(model, f.name).double()
                          for f in dataclasses.fields(model)})


# each kernel's launch counter: its key in control_step.LAUNCHES (entry,
# bodies, model library)
COUNTERS = {"k1": ("step", 24, False), "k2_head": ("head", 24, False),
            "k2_tail": ("tail", 24, False), "k1e": ("step", 24, True),
            "k2e_head": ("head", 24, True), "k2e_tail": ("tail", 24, True),
            "k1f": ("k1f", 24, False),
            "k1g": ("step_refresh", 24, False),
            "k1g_smplh": ("step_refresh", 52, False),
            **{f"{name}_{fam}": (entry, nb, False) for fam, nb in BIG
               for name, entry in (("k1d", "step"), ("k1f", "k1f"),
                                   ("k2big_head", "head"),
                                   ("k2big_tail", "tail"))}}


def reset_counts() -> None:
    from uhc_tpu_torch.physics import control_step as CS

    CS.reset_launches()


def counts() -> dict:
    """Launches of every kernel since the last reset_counts()."""
    from uhc_tpu_torch.physics import control_step as CS

    return {name: CS.LAUNCHES[key] for name, key in COUNTERS.items()}


def expect(steps: int, *kernels) -> dict:
    """The counts a run of `steps` control steps through `kernels` gives."""
    return {k: (steps if k in kernels else 0) for k in counts()}


def run_train(lane, epochs: int, name: str, dev, args=TRAIN_ARGS,
              per_env: bool = False, routed=None, lane_big=None,
              agent_fn=None) -> dict:
    """Drive cli/train on the card with UHC_TPU_LANE=`lane` (None: unset,
    the default routing) and UHC_TPU_LANE_BIG=`lane_big`, or the agent
    `agent_fn(results_dir)` builds through `epochs` of optimize_policy and
    a checkpoint, and check it: launches of the routed kernel (the
    per-env variant over a model library; `routed` names the counters of
    a big tree) exactly one per control step, the eval at the checkpoint
    included, and none of any other, finite stats, the value loss falling
    across every update, and a checkpoint that reloads to the same policy
    bit for bit. Returns the launch counts."""
    import tempfile

    import numpy as np
    import torch

    from uhc_tpu_torch.cli import train
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.learn import nets

    for var, val in (("UHC_TPU_LANE", lane), ("UHC_TPU_LANE_BIG", lane_big)):
        if val is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = val
    eval_steps = 0
    try:
        with tempfile.TemporaryDirectory() as out:
            reset_counts()
            if agent_fn is None:
                agent, hist = train.main(args + [
                    "--epochs", str(epochs), "--results-dir", out])
                if "--no-train-eval" not in args:
                    # the eval at the checkpoint runs every clip to its end
                    eval_steps = int(agent.expert_lib["len"].max()) - 1
            else:
                agent = agent_fn(out)
                hist = [agent.optimize_policy(i) for i in range(epochs)]
                agent.save_checkpoint(epochs)
            got = counts()
            steps = epochs * agent.horizon + eval_steps
            if routed is None:
                routed = {(None, False): ("k1",), (None, True): ("k1e",),
                          ("0", False): ("k2_head", "k2_tail"),
                          ("0", True): ("k2e_head", "k2e_tail")}[lane,
                                                                 per_env]
            want = expect(steps, *routed)
            if got != want:
                raise RuntimeError(f"{name}: launches {got}, expected {want}")
            for i, st in enumerate(hist):
                if not all(np.all(np.isfinite(v)) for v in st.values()):
                    raise RuntimeError(f"{name}: epoch {i} stats not finite: "
                                       f"{st}")
                if not st["value_loss"] < st["value_loss_before"]:
                    raise RuntimeError(
                        f"{name}: epoch {i} value loss {st['value_loss']} "
                        f"not below {st['value_loss_before']} before the "
                        f"update")
            ck = joblib_compat.load(agent.checkpoint_path(epochs))
            policy = nets.policy_from_numpy(ck["policy_params"],
                                            agent.cfg.policy_htype, dev)
            x = torch.randn((agent.num_envs, agent.obs_dim),
                            generator=torch.Generator().manual_seed(5)).to(dev)
            with torch.no_grad():
                same = torch.equal(policy(x), agent.policy(x))
            if not same:
                raise RuntimeError(f"{name}: reloaded checkpoint gives "
                                   f"another policy mean")
    finally:
        os.environ.pop("UHC_TPU_LANE", None)
        os.environ.pop("UHC_TPU_LANE_BIG", None)
    TRAIN_RATES[name] = {
        "rollout_env_steps_per_s": [st["rollout_steps_per_sec"]
                                    for st in hist],
        "ppo_update_ms": [1e3 * st["T_update"] for st in hist]}
    done(name, launches=got, epochs=epochs, cfg=agent.cfg.cfg_id,
         bodies=agent.topo.nbody, num_envs=agent.num_envs,
         horizon=agent.horizon, eval_steps=eval_steps,
         seqs=len(agent.seq_keys), obs_dim=agent.obs_dim,
         action_dim=agent.action_dim,
         rollout_env_steps_per_s=[st["rollout_steps_per_sec"]
                                  for st in hist],
         ppo_update_ms=[1e3 * st["T_update"] for st in hist],
         epoch_s=[st["T_total"] for st in hist],
         reward_mean=[st["reward_mean"] for st in hist],
         value_loss_before=[st["value_loss_before"] for st in hist],
         value_loss_after=[st["value_loss"] for st in hist],
         episodes=[st["episodes"] for st in hist], checkpoint_equal=True)
    return got


def shaped_library(topo, model, max_len=None):
    """The 8 shape clips, each on its own body (synthetic blendshapes):
    (expert library, keys, model library)."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_shaped_library,
                                            load_motion_file)
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data_like

    return build_shaped_library(
        topo, model, load_motion_file(SHAPE_CLIPS),
        synthetic_smpl_data_like(topo, model),
        Config.uhc_implicit_shape().env, max_len=max_len)


def draw_lib_states(lib, B, gen, dev):
    """draw_states over a library with seq_idx spread evenly over all its
    rows: (qpos, qvel, target_base, seq_idx int32)."""
    import torch

    S = lib["qpos"].shape[0]
    si = (torch.arange(B) % S)[torch.randperm(B, generator=gen)].to(dev)
    ti = torch.randint(0, int(lib["len"].min()) - 1, (B,),
                       generator=gen).to(dev)
    qvel = 0.05 * torch.randn((B, 75), generator=gen).to(dev)
    return (lib["qpos"][si, ti].contiguous(), qvel.contiguous(),
            lib["qpos"][si, ti + 1, 7:].contiguous(),
            si.to(torch.int32).contiguous())


def gate(name, out, plain32, plain64) -> tuple:
    """A kernel's (qpos, qvel) against its float32 and float64 plain
    versions at the kernel bounds -> (errors, failures).

    Every env is held to the float64 and the float32 plain version, with
    one exception. An env where the float32 plain version is itself
    outside the bounds of the float64 one (an edge env) sits on a contact
    discontinuity that float32 rounding crosses (a hull point at the
    ground plane switches its damper on or off): there the two plain
    versions land on two sides of the switch, and the kernel is held to
    the side it lands on: to the float32 plain version, or, where it
    misses that one, to the float64 one (printed as
    `edge_held_to_plain64` with both distances). Edge envs are counted and
    printed; more than one in eight fails."""
    import torch

    def per_env(a, b):
        return (a.double() - b.double()).abs().amax(1)

    k64 = [per_env(a, b) for a, b in zip(out, plain64)]
    k32 = [per_env(a, b) for a, b in zip(out, plain32)]
    p64 = [per_env(a, b) for a, b in zip(plain32, plain64)]
    edge = (p64[0] > QPOS_TOL) | (p64[1] > QVEL_TOL)
    # edge envs where the kernel lands with float64 and not with float32
    held64 = (edge & ((k32[0] > QPOS_TOL) | (k32[1] > QVEL_TOL))
              & (k64[0] <= QPOS_TOL) & (k64[1] <= QVEL_TOL))

    def mx(x, mask):
        return x[mask].max().item() if bool(mask.any()) else 0.0

    every = torch.ones_like(edge)
    errs = {"kernel_vs_plain64": [mx(k64[0], ~edge), mx(k64[1], ~edge)],
            "kernel_vs_plain32": [mx(k32[0], ~held64), mx(k32[1], ~held64)],
            "plain32_vs_plain64": [mx(p64[0], every), mx(p64[1], every)],
            "edge_envs": int(edge.sum()),
            "edge_kernel_vs_plain64": [mx(k64[0], edge), mx(k64[1], edge)],
            "edge_plain32_vs_plain64": [mx(p64[0], edge), mx(p64[1], edge)],
            "edge_held_to_plain64": [
                {"env": e, "kernel_vs_plain64": [k64[0][e].item(),
                                                 k64[1][e].item()],
                 "kernel_vs_plain32": [k32[0][e].item(), k32[1][e].item()]}
                for e in torch.nonzero(held64)[:, 0].tolist()]}
    fails = []
    for yardstick in ("kernel_vs_plain64", "kernel_vs_plain32"):
        dq, dv = errs[yardstick]
        if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
            fails.append(f"{name}: {yardstick} |dqpos| {dq} (bound "
                         f"{QPOS_TOL}), |dqvel| {dv} (bound {QVEL_TOL})")
    if int(edge.sum()) * 8 > edge.numel():
        fails.append(f"{name}: {int(edge.sum())} of {edge.numel()} envs "
                     "have the float32 plain version outside the bounds of "
                     "the float64 one")
    return errs, fails


def on_tree(env_cfg, family: str):
    """`env_cfg` on a big tree: "smplh" or "masterfoot"."""
    import dataclasses

    return dataclasses.replace(env_cfg, robot_model="smplh"
                               if family == "smplh" else "smpl",
                               masterfoot=family == "masterfoot")


def plain_pair(topo, env_cfg, model, ins, pcg_iters, refresh_at=None):
    """The float32 and float64 plain versions of one control step of `ins`
    -> (plain32, plain64)."""
    from uhc_tpu_torch.physics import control_step as CS

    return (CS.control_step_reference(topo, env_cfg, model, *ins, 1.0,
                                      pcg_iters, refresh_at=refresh_at),
            CS.control_step_reference(
                topo, env_cfg, double_model(model),
                *[t.double() for t in ins], 1.0, pcg_iters,
                refresh_at=refresh_at))


def big_tree(family: str, dev, meta_pd: bool = False):
    """uhc_implicit on a big tree built from the stand-in: "smplh" (52
    bodies) or "masterfoot" (48) -> (topo, env cfg, model, expert library
    of the gait clips on that tree)."""
    import dataclasses

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.learn.agent import robot_family
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    env = on_tree(dataclasses.replace(Config.uhc_implicit().env,
                                      meta_pd=meta_pd), family)
    topo24, model24 = load_fixture_humanoid()
    topo, model_np, conv, _, _ = robot_family(topo24, model24, env)
    model = model_from_numpy(model_np, dev)
    lib, _ = build_expert_library(
        topo, model, load_motion_file("sample_data/gait_clips.pkl"),
        converter=conv, base_root_offset=(None if conv is None
                                          else model_np.body_pos[0]))
    return topo, env, model, lib


def draw_big_states(lib, nv, B, gen, dev):
    """draw_states over a big tree's library (qvel of width nv)."""
    import torch

    S = lib["qpos"].shape[0]
    si = torch.randint(0, S, (B,), generator=gen).to(dev)
    ti = torch.randint(0, int(lib["len"].min()) - 1, (B,),
                       generator=gen).to(dev)
    qvel = 0.05 * torch.randn((B, nv), generator=gen).to(dev)
    return (lib["qpos"][si, ti].contiguous(), qvel.contiguous(),
            lib["qpos"][si, ti + 1, 7:].contiguous())


def k1d_draws(dev):
    """The draws of phase k1d_vs_plain, one case after another: (family,
    mode, topo, env cfg, model, (qpos, qvel, actions, target_base)) for
    SMPL-H and masterfoot, plain PD and meta-PD, B_CHECK envs each, made
    on the host from one seeded generator and moved to `dev`."""
    import torch

    from uhc_tpu_torch.physics import solver

    gen = torch.Generator().manual_seed(13)
    for fam, _ in BIG:
        for mode in ("plain_pd", "meta_pd"):
            btopo, benv, bmodel, blib = big_tree(fam, dev,
                                                 mode == "meta_pd")
            qpos, qvel, tb = draw_big_states(blib, btopo.nv, B_CHECK, gen,
                                             dev)
            n_act = sum(solver.action_dims(btopo, benv))
            act = (0.02 * torch.randn((B_CHECK, n_act),
                                      generator=gen)).to(dev)
            yield fam, mode, btopo, benv, bmodel, (qpos, qvel, act, tb)


# a missed env's state moved by 1 and by 2 float32 ulps (relative 2⁻²³ per
# ulp, every entry of qpos and qvel, seeded signs), MOVES copies each
ULP_MOVES, MOVES = (1, 2), 32


def moved_steps(topo, env_cfg, model, ins, env, dtype, seed=0, trace=None,
                pcg_iters=(2, 2), refresh_at=None):
    """The plain step in `dtype` at `pcg_iters` (the big trees' (2, 2) by
    default; with K1g's `refresh_at`) of env `env` of `ins` (qpos, qvel,
    actions, target_base) from copies of its state moved by ULP_MOVES
    float32 ulps -> (qpos', qvel') of the len(ULP_MOVES) * MOVES copies;
    `trace` receives each substep's ground-contact sets."""
    import torch

    from uhc_tpu_torch.physics import solver

    qpos, qvel, act, tb = [x[env:env + 1].to(dtype) for x in ins]
    n = len(ULP_MOVES) * MOVES
    gen = torch.Generator().manual_seed(seed)
    rel = torch.tensor([u * 2.0 ** -23 for u in ULP_MOVES
                        for _ in range(MOVES)], dtype=dtype)[:, None]

    def move(x):
        sign = 2 * torch.randint(0, 2, (n, x.shape[1]), generator=gen) - 1
        return (x * (1 + (rel * sign).to(x))).contiguous()

    m = model if dtype == torch.float32 else double_model(model)
    return solver.do_simulation(
        topo, env_cfg, m, move(qpos), move(qvel),
        act.expand(n, -1).contiguous(), tb.expand(n, -1).contiguous(), 1.0,
        pcg_iters, trace=trace, refresh_at=refresh_at)


def gate_big(name, out, plain32, plain64, moved) -> tuple:
    """A big-tree kernel's (qpos, qvel) against its float32 and float64
    plain versions -> (errors, failures).

    On a big tree's clip frames many hull points sit at the ground plane,
    where a contact switches on or off within float32 rounding of the
    state: there two float32 computations of one step may land on
    different sides of the switch, and the float32 plain version itself
    misses the bounds of the float64 one on some envs (masterfoot: 2-3 %).
    Near such a switch the float32 results spread over up to twice the
    bounds while each stays inside them. So each env is held so:
    - every env where the kernel is inside the bounds of the float64
      plain version and the float32 plain version is within a tenth of
      them (a sharp env: no switch near) is held to the float32 plain
      version at the bounds too, as `gate` holds the 24-body kernels;
    - an env where the kernel misses the bounds of the float64 plain
      version passes only (a) where the float32 plain version is not
      sharp either and the kernel's distance from the float64 one is no
      larger than the float32 plain version's worst miss on the same
      draws (each of qpos and qvel), or (b) where a witness shows the
      kernel's answer is one float32 arithmetic reaches from that state:
      one of the plain steps `moved(env)` returns (the float64 and float32
      plain versions from the state moved by one or two float32 ulps)
      lands within the bounds of the kernel's;
    - the kernel may miss on no more envs than the float32 plain version
      does, plus half that and one, and on at most one env in eight.
    Every missed env is printed: the kernel's and the float32 plain
    version's distances from the float64 one, the rule it passed by, and
    for a witness the nearest moved step (in units of the bounds) and how
    many moved steps land within the bounds."""
    import torch

    def per_env(a, b):
        return (a.double() - b.double()).abs().amax(1)

    k64 = [per_env(a, b) for a, b in zip(out, plain64)]
    k32 = [per_env(a, b) for a, b in zip(out, plain32)]
    p64 = [per_env(a, b) for a, b in zip(plain32, plain64)]
    k_out = (k64[0] > QPOS_TOL) | (k64[1] > QVEL_TOL)
    p_out = (p64[0] > QPOS_TOL) | (p64[1] > QVEL_TOL)
    sharp = (p64[0] <= QPOS_TOL / 10) & (p64[1] <= QVEL_TOL / 10)
    every = torch.ones_like(k_out)

    def mx(x, mask):
        return x[mask].max().item() if bool(mask.any()) else 0.0

    worst32 = [max(QPOS_TOL, mx(p64[0], p_out)),
               max(QVEL_TOL, mx(p64[1], p_out))]
    fails, missed = [], []
    for e in torch.nonzero(k_out)[:, 0].tolist():
        row = {"env": e, "kernel_vs_plain64": [k64[0][e].item(),
                                               k64[1][e].item()],
               "plain32_vs_plain64": [p64[0][e].item(), p64[1][e].item()]}
        if not sharp[e] and k64[0][e] <= worst32[0] \
                and k64[1][e] <= worst32[1]:
            row["passed_by"] = "float32_worst_miss"
        else:
            ratio = torch.cat([torch.maximum(
                per_env(q, out[0][e:e + 1]) / QPOS_TOL,
                per_env(v, out[1][e:e + 1]) / QVEL_TOL)
                for q, v in moved(e)])
            row["nearest_moved_step"] = ratio.min().item()
            row["moved_steps_within_bounds"] = int((ratio <= 1).sum())
            if row["moved_steps_within_bounds"]:
                row["passed_by"] = "witness"
            else:
                row["passed_by"] = None
                fails.append(f"{name}: env {e} misses the float64 plain "
                             f"version by {row['kernel_vs_plain64']} (the "
                             f"float32 plain version by "
                             f"{row['plain32_vs_plain64']}, its worst miss "
                             f"{worst32}), and no plain step from its state "
                             f"moved by {ULP_MOVES} float32 ulps lands "
                             f"there (nearest {row['nearest_moved_step']} "
                             f"× the bounds)")
        missed.append(row)
    held32 = sharp & ~k_out
    errs = {"kernel_vs_plain64": [mx(k64[0], ~p_out), mx(k64[1], ~p_out)],
            "kernel_vs_plain64_every_env": [mx(k64[0], every),
                                            mx(k64[1], every)],
            "kernel_vs_plain32_sharp": [mx(k32[0], held32),
                                        mx(k32[1], held32)],
            "kernel_vs_plain32": [mx(k32[0], every), mx(k32[1], every)],
            "plain32_vs_plain64": [mx(p64[0], every), mx(p64[1], every)],
            "sharp_envs": int(sharp.sum()),
            "kernel_misses": int(k_out.sum()),
            "plain32_misses": int(p_out.sum()),
            "both_miss": int((k_out & p_out).sum()),
            "plain32_only_misses": [[e, p64[0][e].item(), p64[1][e].item()]
                                    for e in torch.nonzero(p_out & ~k_out)
                                    [:, 0].tolist()],
            "kernel_missed_envs": missed}
    dq, dv = errs["kernel_vs_plain32_sharp"]
    if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
        fails.append(f"{name}: kernel_vs_plain32 on the sharp envs |dqpos| "
                     f"{dq} (bound {QPOS_TOL}), |dqvel| {dv} (bound "
                     f"{QVEL_TOL})")
    n_k, n_p = errs["kernel_misses"], errs["plain32_misses"]
    if n_k > n_p + n_p // 2 + 1:
        fails.append(f"{name}: the kernel misses the bounds of the float64 "
                     f"plain version on {n_k} envs, the float32 plain "
                     f"version on {n_p}")
    if n_k * 8 > k_out.numel():
        fails.append(f"{name}: the kernel misses the bounds on {n_k} of "
                     f"{k_out.numel()} envs")
    return errs, fails


def big_rows(fam, src, k2_src, train_counts, k1d_err, head_err,
             timing) -> list:
    """The kernels-line rows of K1d and of K2's head and tail on one big
    tree: launches from its training phases, times at B_BIG_TIME[0]."""
    t = timing[f"B{B_BIG_TIME[0]}"]
    split = train_counts[f"train_{fam}_split"]
    return [
        {"name": f"control_step_big_{fam}", "route": "cuda", "source": src,
         "replaces": "uhc_tpu/physics/pallas_lane.py:83",
         "launches": train_counts[f"train_{fam}"][f"k1d_{fam}"],
         "max_abs_err": k1d_err, "ms": t["k1d_ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound"]["k1d"]["bound_ms"],
         "bound_by": t["bound"]["k1d"]["bound_by"], "library_ms": None},
        {"name": f"control_step_head_big_{fam}", "route": "cuda",
         "source": src, "replaces": k2_src,
         "launches": split[f"k2big_head_{fam}"],
         "max_abs_err": head_err, "ms": t["head_ms"],
         "plain_ms": t["plain_head_ms"],
         "bound_ms": t["bound"]["head"]["bound_ms"],
         "bound_by": t["bound"]["head"]["bound_by"], "library_ms": None},
        {"name": f"control_step_tail_big_{fam}", "route": "cuda",
         "source": src, "replaces": k2_src,
         "launches": split[f"k2big_tail_{fam}"],
         # head + tail equal K1d bit for bit (phase k2_big)
         "max_abs_err": k1d_err, "ms": t["tail_ms"],
         "plain_ms": t["plain_tail_ms"],
         "bound_ms": t["bound"]["tail"]["bound_ms"],
         "bound_by": t["bound"]["tail"]["bound_by"], "library_ms": None}]


def k1f_modes():
    """K1f's five modes: explicit RFC without a gate, with the "height"
    and the "ground" gate, per-joint meta-PD, and both together -> {mode:
    env config}, from the `explicit` and `meta_joint` configs."""
    import dataclasses

    from uhc_tpu_torch.config.config import EXPLICIT, META_JOINT, Config

    ex = Config.from_dict("explicit", EXPLICIT).env
    return {"explicit": ex,
            "explicit_height": dataclasses.replace(
                ex, residual_contact_only=True),
            "explicit_ground": dataclasses.replace(
                ex, residual_contact_only=True,
                residual_contact_only_ground=True),
            "meta_joint": Config.from_dict("meta_joint", META_JOINT).env,
            "explicit_meta_joint": dataclasses.replace(ex,
                                                       meta_pd_joint=True)}


def k1f_draw(topo, env_cfg, lib, B, gen, dev):
    """draw_states on any tree with every K1F_LOWERED-th env lowered by
    K1F_SINK and seeded actions: 0.02 noise, plus 0.05 on the explicit
    wrench columns so that they matter -> (qpos, qvel, actions,
    target_base)."""
    import torch

    from uhc_tpu_torch.physics import solver

    qpos, qvel, tb = draw_big_states(lib, topo.nv, B, gen, dev)
    qpos[::K1F_LOWERED, 2] -= K1F_SINK
    nd, vf, meta = solver.action_dims(topo, env_cfg)
    act = 0.02 * torch.randn((B, nd + vf + meta), generator=gen)
    if solver.explicit_rfc(env_cfg):
        act[:, nd:nd + vf] += 0.05 * torch.randn((B, vf), generator=gen)
    return qpos, qvel, act.to(dev), tb


def k1f_zeroed(topo, env_cfg, act) -> dict:
    """The actions with each of K1f's terms zeroed: the explicit wrench
    columns, the per-joint meta-PD columns (scales 1) -> {term: actions}."""
    from uhc_tpu_torch.physics import solver

    nd, vf, _ = solver.action_dims(topo, env_cfg)
    out = {}
    if solver.explicit_rfc(env_cfg):
        out["wrench"] = act.clone()
        out["wrench"][:, nd:nd + vf] = 0.0
    if solver.per_joint_gains(env_cfg):
        out["per_dof_gains"] = act.clone()
        out["per_dof_gains"][:, nd + vf:] = 0.0
    return out


def k1f_check(topo, model, lib, gen, dev) -> tuple:
    """K1f in its five modes on B_CHECK clip-frame states, a share of them
    lowered, against its float32 and float64 plain versions through `gate`
    (qpos QPOS_TOL, qvel QVEL_TOL), one launch each, and zeroing each of
    its terms moving qpos by more than QPOS_TOL -> ({mode: errors},
    failures)."""
    import torch

    from uhc_tpu_torch.physics import control_step as CS

    errs, fails = {}, []
    for mode, env_cfg in k1f_modes().items():
        step = CS.ControlStep(topo, env_cfg, model, pcg_iters=(1, 2))
        ins = k1f_draw(topo, env_cfg, lib, B_CHECK, gen, dev)
        reset_counts()
        out = step(*ins, 1.0)
        torch.cuda.synchronize()
        if counts() != expect(1, "k1f") or not all(
                bool(torch.isfinite(t).all()) for t in out):
            raise RuntimeError(f"K1f {mode}: launches {counts()} or output "
                               "not finite")
        plain32, plain64 = plain_pair(topo, env_cfg, model, ins, (1, 2))
        e, f = gate(f"K1f {mode}", out, plain32, plain64)
        qpos, qvel, act, tb = ins
        e["zeroed_moves_qpos"] = {}
        for term, act0 in k1f_zeroed(topo, env_cfg, act).items():
            moved = (step(qpos, qvel, act0, tb, 1.0)[0]
                     - out[0]).abs().max().item()
            e["zeroed_moves_qpos"][term] = moved
            if not moved > QPOS_TOL:
                f.append(f"K1f {mode}: zeroing the {term} moves qpos by "
                         f"{moved} only")
        e["act_dim"] = step.act_dim
        e["lowered_envs"] = len(range(0, B_CHECK, K1F_LOWERED))
        errs[mode] = e
        fails += f
    return errs, fails


def k1f_big_draws(dev):
    """The draws of phase k1f_big, one case after another: (family, mode,
    topo, env cfg, model, (qpos, qvel, actions, target_base)) for SMPL-H
    and masterfoot in each of K1F_BIG_MODES, B_CHECK clip-frame envs each
    (every K1F_LOWERED-th lowered by K1F_SINK), made on the host from one
    seeded generator and moved to `dev`."""
    import torch

    gen = torch.Generator().manual_seed(17)
    for fam, _ in BIG:
        btopo, _, bmodel, blib = big_tree(fam, dev)
        for mode in K1F_BIG_MODES:
            env_cfg = on_tree(k1f_modes()[mode], fam)
            yield fam, mode, btopo, env_cfg, bmodel, k1f_draw(
                btopo, env_cfg, blib, B_CHECK, gen, dev)


def k1f_big_check(draws) -> tuple:
    """K1f on the big trees at (2, 2) on `draws` (k1f_big_draws), one launch
    each, through `gate_big` against its float32 and float64 plain
    versions, and zeroing each of its terms moving qpos by more than
    QPOS_TOL -> ({family_mode: errors}, failures)."""
    import torch

    from uhc_tpu_torch.physics import control_step as CS

    errs, fails = {}, []
    for fam, mode, btopo, env_cfg, bmodel, ins in draws:
        name = f"K1f {fam} {mode}"
        step = CS.ControlStep(btopo, env_cfg, bmodel, (2, 2))
        reset_counts()
        out = step(*ins, 1.0)
        torch.cuda.synchronize()
        if counts() != expect(1, f"k1f_{fam}") or not all(
                bool(torch.isfinite(t).all()) for t in out):
            raise RuntimeError(f"{name}: launches {counts()} or output not "
                               "finite")
        plain32, plain64 = plain_pair(btopo, env_cfg, bmodel, ins, (2, 2))

        def moved(e, btopo=btopo, env_cfg=env_cfg, bmodel=bmodel, ins=ins):
            return [moved_steps(btopo, env_cfg, bmodel, ins, e, dt)
                    for dt in (torch.float64, torch.float32)]

        e, f = gate_big(name, out, plain32, plain64, moved)
        qpos, qvel, act, tb = ins
        e["zeroed_moves_qpos"] = {}
        for term, act0 in k1f_zeroed(btopo, env_cfg, act).items():
            gap = (step(qpos, qvel, act0, tb, 1.0)[0]
                   - out[0]).abs().max().item()
            e["zeroed_moves_qpos"][term] = gap
            if not gap > QPOS_TOL:
                f.append(f"{name}: zeroing the {term} moves qpos by {gap} "
                         "only")
        e["act_dim"] = step.act_dim
        e["kept_action_columns"] = CS.kept_action_columns(btopo, env_cfg)
        errs[f"{fam}_{mode}"] = e
        fails += f
    return errs, fails


def k1g_check(topo, env_cfg, model, ins, pcg_iters, family=None) -> tuple:
    """K1g, the control step with `refresh_at=REFRESH_AT` at `pcg_iters`,
    on `ins` (the 24-body tree, or the big tree `family`): one launch,
    held against its float32 and float64 plain versions by `gate_big`
    (one PCG iteration per solve spreads float32 results as the big
    trees' contact switches do: on one plain-PD env of the 24-body draws,
    float32 steps from its state moved by 1-2 ulps land 1.4e-4 to 2.8e-3
    from the float64 one in qvel, either side of QVEL_TOL), within
    SCHED_QPOS_TOL / SCHED_QVEL_TOL of the float64 plain PCG-8 step, and
    apart from the same step without the refresh by more than QPOS_TOL in
    qpos -> (errors, failures, the kernel's output).

    The PCG-8 bounds are the schedule's, not the kernel's: an env where
    the float64 plain version of the same schedule misses them itself (a
    state that one PCG iteration does not solve to them) is held to its
    plain versions alone, as above, and printed with both distances; more
    than one such env in eight fails."""
    import torch

    from uhc_tpu_torch.physics import control_step as CS

    name = f"K1g {family or 24}"
    step = CS.ControlStep(topo, env_cfg, model, pcg_iters,
                          refresh_at=REFRESH_AT)
    reset_counts()
    out = step(*ins, 1.0)
    torch.cuda.synchronize()
    key = "k1g" if family is None else f"k1g_{family}"
    if counts() != expect(1, key) or not all(
            bool(torch.isfinite(t).all()) for t in out):
        raise RuntimeError(f"{name}: launches {counts()} or output not "
                           "finite")
    plain32, plain64 = plain_pair(topo, env_cfg, model, ins, pcg_iters,
                                  REFRESH_AT)

    def moved(env):
        return [moved_steps(topo, env_cfg, model, ins, env, dt,
                            pcg_iters=pcg_iters, refresh_at=REFRESH_AT)
                for dt in (torch.float64, torch.float32)]

    e, f = gate_big(name, out, plain32, plain64, moved)
    _, pcg8 = plain_pair(topo, env_cfg, model, ins, PCG8)

    def from_pcg8(x):
        return [(a.double() - b).abs().amax(1) for a, b in zip(x, pcg8)]

    k8, p8 = from_pcg8(out), from_pcg8(plain64)
    sched = (p8[0] > SCHED_QPOS_TOL) | (p8[1] > SCHED_QVEL_TOL)
    e["kernel_vs_pcg8_plain64"] = [x[~sched].max().item() if bool(
        (~sched).any()) else 0.0 for x in k8]
    e["schedule_misses_pcg8"] = [
        {"env": i, "kernel_vs_pcg8": [k8[0][i].item(), k8[1][i].item()],
         "plain64_vs_pcg8": [p8[0][i].item(), p8[1][i].item()]}
        for i in torch.nonzero(sched)[:, 0].tolist()]
    dq, dv = e["kernel_vs_pcg8_plain64"]
    if not (dq <= SCHED_QPOS_TOL and dv <= SCHED_QVEL_TOL):
        f.append(f"{name}: |dqpos| {dq}, |dqvel| {dv} from the PCG-8 step "
                 f"(bounds {SCHED_QPOS_TOL}, {SCHED_QVEL_TOL})")
    if int(sched.sum()) * 8 > sched.numel():
        f.append(f"{name}: the plain version misses the PCG-8 step on "
                 f"{int(sched.sum())} of {sched.numel()} envs")
    unrefreshed = CS.ControlStep(topo, env_cfg, model, pcg_iters)(*ins, 1.0)
    e["refresh_moves_qpos"] = (out[0] - unrefreshed[0]).abs().max().item()
    e["unrefreshed_vs_pcg8_plain64"] = [
        (a.double() - b).abs().max().item()
        for a, b in zip(unrefreshed, pcg8)]
    if not e["refresh_moves_qpos"] > QPOS_TOL:
        f.append(f"{name}: the refresh moves qpos by "
                 f"{e['refresh_moves_qpos']} only")
    e["pcg_iters"] = list(pcg_iters)
    return e, f, out


def k1e_check(topo, env_cfg, lib_model, ins, name):
    """K1e over `lib_model` on `ins` (qpos, qvel, act, tb, seq) through
    `gate` -> (errors, failures)."""
    import torch

    from uhc_tpu_torch.physics import control_step as CS

    qpos, qvel, act, tb, seq = ins
    step = CS.ControlStep(topo, env_cfg, lib_model, pcg_iters=(1, 2))
    out = step(qpos, qvel, act, tb, 1.0, seq)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise RuntimeError(f"{name}: K1e output not finite")
    plain64 = CS.control_step_reference(
        topo, env_cfg, double_model(lib_model),
        *[t.double() for t in (qpos, qvel, act, tb)], 1.0, (1, 2), seq)
    plain32 = CS.control_step_reference(topo, env_cfg, lib_model, qpos,
                                        qvel, act, tb, 1.0, (1, 2), seq)
    return gate(f"K1e {name}", out, plain32, plain64)


def run() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "uhc_tpu_torch")):
        raise RuntimeError(f"no uhc_tpu_torch package next to {__file__}: "
                           "run this script from a checkout of the repo")
    sys.path.insert(0, here)
    os.chdir(here)
    # default routing (K1) everywhere but the train_split phase
    os.environ.pop("UHC_TPU_LANE", None)

    phase("device")
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this "
                           "script needs a CUDA card")
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip().splitlines()[0]
    done("device", card=card, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         python=sys.version.split()[0], count=torch.cuda.device_count())

    phase("build", "(nvcc, sm_90a; 24, 48 and 52 bodies, one nvcc each, "
                   "at once)")
    from uhc_tpu_torch.csrc import build

    t0 = time.perf_counter()
    libs = build.build_libraries(BODIES)
    lib_cuda = libs[24]

    def ptxas(nb):
        return [ln.strip() for ln in build.build_log.get(
            ("cuda", nb), {}).get("stderr", "").splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]

    done("build", seconds=time.perf_counter() - t0,
         layout=build.layout(lib_cuda), ptxas=ptxas(24),
         big={nb: {"layout": build.layout(libs[nb]), "ptxas": ptxas(nb),
                   "seconds": build.build_log.get(("cuda", nb), {}).get(
                       "seconds")} for nb in BODIES[1:]})

    phase("kernel_vs_plain", f"(B={B_CHECK}, plain PD and meta-PD)")
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    cfg = Config.uhc_implicit()
    topo, model_np = load_fixture_humanoid()
    model = model_from_numpy(model_np, dev)
    lib, keys = build_expert_library(
        topo, model, load_motion_file("sample_data/gait_clips.pkl"))
    gen = torch.Generator().manual_seed(0)
    model64 = double_model(model)
    max_err = 0.0
    errs = {}
    draws = {}
    for mode, env_cfg in (("plain_pd", cfg.env),
                          ("meta_pd", dataclasses.replace(cfg.env,
                                                          meta_pd=True))):
        step = CS.ControlStep(topo, env_cfg, model, pcg_iters=(1, 2))
        qpos, qvel, tb = draw_states(lib, B_CHECK, gen, dev)
        act = (0.02 * torch.randn((B_CHECK, step.act_dim),
                                  generator=gen)).to(dev)
        draws[mode] = (env_cfg, qpos, qvel, act, tb)
        qk, vk = step(qpos, qvel, act, tb, 1.0)
        torch.cuda.synchronize()
        if not (torch.isfinite(qk).all() and torch.isfinite(vk).all()):
            raise RuntimeError(f"{mode}: kernel output not finite")
        # the kernel is held at the same bounds against the plain version
        # in float32 and in float64; the float32 plain version's own
        # distance to the float64 one is printed beside them
        q64, v64 = CS.control_step_reference(
            topo, env_cfg, model64, qpos.double(), qvel.double(),
            act.double(), tb.double(), 1.0, (1, 2))
        qr, vr = CS.control_step_reference(topo, env_cfg, model, qpos, qvel,
                                           act, tb, 1.0, (1, 2))
        errs[mode] = {
            "kernel_vs_plain64": [(qk.double() - q64).abs().max().item(),
                                  (vk.double() - v64).abs().max().item()],
            "kernel_vs_plain32": [(qk - qr).abs().max().item(),
                                  (vk - vr).abs().max().item()],
            "plain32_vs_plain64": [(qr.double() - q64).abs().max().item(),
                                   (vr.double() - v64).abs().max().item()]}
        for yardstick in ("kernel_vs_plain64", "kernel_vs_plain32"):
            dq, dv = errs[mode][yardstick]
            if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
                raise RuntimeError(f"{mode}: {yardstick} |dqpos| {dq} "
                                   f"(bound {QPOS_TOL}), |dqvel| {dv} "
                                   f"(bound {QVEL_TOL})")
            max_err = max(max_err, dq, dv)
    done("kernel_vs_plain", **errs, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL)

    phase("k2_vs_plain", f"(B={B_CHECK}, the same draws, schedule (2, 2))")
    k2_err = {"head": 0.0, "tail": 0.0}
    errs2 = {}
    for mode, (env_cfg, qpos, qvel, act, tb) in draws.items():
        split = K2.ControlStepSplit(topo, env_cfg, model, 2)
        qh, vh, X = split.head(qpos, qvel, act, tb, 1.0)
        q2, v2 = split.tail(qh, vh, act, tb, X, 1.0)
        q1, v1 = CS.ControlStep(topo, env_cfg, model, (2, 2))(
            qpos, qvel, act, tb, 1.0)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (q2, v2, X)):
            raise RuntimeError(f"{mode}: K2 output not finite")
        if not (torch.equal(q1, q2) and torch.equal(v1, v2)):
            raise RuntimeError(
                f"{mode}: K2 head + tail differ from K1 at (2, 2): "
                f"|dqpos| {(q1 - q2).abs().max().item()}, |dqvel| "
                f"{(v1 - v2).abs().max().item()}")
        ins64 = [t.double() for t in (qpos, qvel, act, tb)]
        q64, v64 = CS.control_step_reference(topo, env_cfg, model64, *ins64,
                                             1.0, (2, 2))
        qr, vr = CS.control_step_reference(topo, env_cfg, model, qpos, qvel,
                                           act, tb, 1.0, (2, 2))
        qh64, vh64, X64 = K2.head_reference(topo, env_cfg, model64, *ins64,
                                            1.0, 2)
        scale = X64.abs().amax((2, 3), keepdim=True)
        errs2[mode] = {
            "split_vs_plain64": [(q2.double() - q64).abs().max().item(),
                                 (v2.double() - v64).abs().max().item()],
            "split_vs_plain32": [(q2 - qr).abs().max().item(),
                                 (v2 - vr).abs().max().item()],
            "plain32_vs_plain64": [(qr.double() - q64).abs().max().item(),
                                   (vr.double() - v64).abs().max().item()],
            "head_vs_plain64": [(qh.double() - qh64).abs().max().item(),
                                (vh.double() - vh64).abs().max().item()],
            "head_X_vs_plain64": [(X.double() - X64).abs().max().item(),
                                  ((X.double() - X64).abs() / scale).max()
                                  .item()],
            "split_equals_k1": True}
        for yardstick in ("split_vs_plain64", "split_vs_plain32"):
            dq, dv = errs2[mode][yardstick]
            if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
                raise RuntimeError(f"{mode}: K2 {yardstick} |dqpos| {dq} "
                                   f"(bound {QPOS_TOL}), |dqvel| {dv} "
                                   f"(bound {QVEL_TOL})")
            k2_err["tail"] = max(k2_err["tail"], dq, dv)
        if not errs2[mode]["head_X_vs_plain64"][1] <= X_REL_TOL:
            raise RuntimeError(f"{mode}: K2 head Xp/Xf relative error "
                               f"{errs2[mode]['head_X_vs_plain64'][1]} "
                               f"(bound {X_REL_TOL})")
        k2_err["head"] = max(k2_err["head"], *errs2[mode]["head_vs_plain64"])
    done("k2_vs_plain", **errs2, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL,
         x_rel_tol=X_REL_TOL)

    phase("k1e_vs_plain", f"(B={B_CHECK}, shaped and DR libraries, plain PD "
                          "and meta-PD)")
    from uhc_tpu_torch.data.dataset import build_dr_library

    gen_e = torch.Generator().manual_seed(11)
    slib, skeys, smodel = shaped_library(topo, model)
    dlib, _, dmodel = build_dr_library(
        topo, model, load_motion_file("sample_data/gait_clips.pkl"), 4)
    k1e_err = 0.0
    errs_e = {}
    k1e_fails = []
    for mode, env_cfg in (("plain_pd", cfg.env),
                          ("meta_pd", dataclasses.replace(cfg.env,
                                                          meta_pd=True))):
        act_dim = 75 + (30 if env_cfg.meta_pd else 0)
        for lname, elib, emodel in (("shape", slib, smodel),
                                    ("dr", dlib, dmodel)):
            qpos, qvel, tb, seq = draw_lib_states(elib, B_CHECK, gen_e, dev)
            act = (0.02 * torch.randn((B_CHECK, act_dim),
                                      generator=gen_e)).to(dev)
            errs_e[f"{lname}_{mode}"], fails = k1e_check(
                topo, env_cfg, emodel, (qpos, qvel, act, tb, seq),
                f"{lname} {mode}")
            k1e_fails += fails
            k1e_err = max(k1e_err, *errs_e[f"{lname}_{mode}"][
                "kernel_vs_plain64"], *errs_e[f"{lname}_{mode}"][
                "kernel_vs_plain32"])
            if lname != "shape":
                continue
            # K2 over the library, head + tail, equals K1e at (2, 2)
            split = K2.ControlStepSplit(topo, env_cfg, emodel, 2)
            qh, vh, X = split.head(qpos, qvel, act, tb, 1.0, seq)
            q2, v2 = split.tail(qh, vh, act, tb, X, 1.0, seq)
            q1, v1 = CS.ControlStep(topo, env_cfg, emodel, (2, 2))(
                qpos, qvel, act, tb, 1.0, seq)
            torch.cuda.synchronize()
            if not (torch.equal(q1, q2) and torch.equal(v1, v2)):
                raise RuntimeError(
                    f"{mode}: K2 over the library differs from K1e at "
                    f"(2, 2): |dqpos| {(q1 - q2).abs().max().item()}, "
                    f"|dqvel| {(v1 - v2).abs().max().item()}")
            ins64 = [t.double() for t in (qpos, qvel, act, tb)]
            plain64 = CS.control_step_reference(
                topo, env_cfg, double_model(emodel), *ins64, 1.0, (2, 2),
                seq)
            plain32 = CS.control_step_reference(
                topo, env_cfg, emodel, qpos, qvel, act, tb, 1.0, (2, 2),
                seq)
            qh64, vh64, _ = K2.head_reference(
                topo, env_cfg, double_model(emodel), *ins64, 1.0, 2, seq)
            e2, fails = gate(f"K2 over the library {mode}", (q2, v2),
                             plain32, plain64)
            k1e_fails += fails
            e2.update(head_vs_plain64=[(qh.double() - qh64).abs().max()
                                       .item(), (vh.double() - vh64).abs()
                                       .max().item()],
                      split_equals_k1e=True)
            errs_e[f"k2e_{mode}"] = e2
            k2_err["head_pe"] = max(k2_err.get("head_pe", 0.0),
                                    *e2["head_vs_plain64"])
            k2_err["tail_pe"] = max(k2_err.get("tail_pe", 0.0),
                                    *e2["kernel_vs_plain64"],
                                    *e2["kernel_vs_plain32"])
        # a library whose rows all equal the shared model gives K1's
        # results bit for bit
        same = dataclasses.replace(
            model, body_pos=model.body_pos.expand(8, -1, -1).clone(),
            friction=model.friction.expand(8).clone())
        qpos, qvel, tb, seq = draw_lib_states(slib, B_CHECK, gen_e, dev)
        act = (0.02 * torch.randn((B_CHECK, act_dim),
                                  generator=gen_e)).to(dev)
        qs, vs = CS.ControlStep(topo, env_cfg, model, (1, 2))(
            qpos, qvel, act, tb, 1.0)
        qe, ve = CS.ControlStep(topo, env_cfg, same, (1, 2))(
            qpos, qvel, act, tb, 1.0, seq)
        torch.cuda.synchronize()
        if not (torch.equal(qs, qe) and torch.equal(vs, ve)):
            raise RuntimeError(f"{mode}: equal-row library differs from "
                               "the shared model")
        # two bodies integrate differently from the same state
        one = [t[:1].repeat(2, 1) for t in (qpos, qvel, act, tb)]
        one[0][:] = slib["qpos"][4, 0]
        q2b, _ = CS.ControlStep(topo, env_cfg, smodel, (1, 2))(
            *one, 1.0, torch.tensor([0, 5], dtype=torch.int32, device=dev))
        shape_gap = (q2b[0] - q2b[1]).abs().max().item()
        if not shape_gap > 1e-6:
            raise RuntimeError(f"{mode}: two bodies integrate alike "
                               f"({shape_gap})")
        errs_e[f"equal_rows_{mode}"] = True
        errs_e[f"shape_gap_{mode}"] = shape_gap
    done("k1e_vs_plain", **errs_e, library_rows={"shape": len(skeys),
                                                  "dr": int(dmodel.friction
                                                            .shape[0])},
         qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL)
    if k1e_fails:
        raise RuntimeError("; ".join(k1e_fails))

    phase("k1d_vs_plain", f"(B={B_CHECK}, SMPL-H and masterfoot, plain PD "
                          "and meta-PD, (2, 2))")
    k1d_err, k1d_errs, k1d_fails = {}, {}, []
    big_draws = {}
    for fam, mode, btopo, benv, bmodel, ins in k1d_draws(dev):
        step = CS.ControlStep(btopo, benv, bmodel, (2, 2))
        big_draws[fam, mode] = (btopo, benv, bmodel, *ins)
        reset_counts()
        out = step(*ins, 1.0)
        torch.cuda.synchronize()
        if counts() != expect(1, f"k1d_{fam}") or not all(
                bool(torch.isfinite(t).all()) for t in out):
            raise RuntimeError(f"K1d {fam} {mode}: launches {counts()} or "
                               "output not finite")
        plain32, plain64 = plain_pair(btopo, benv, bmodel, ins, (2, 2))

        def moved(e, btopo=btopo, benv=benv, bmodel=bmodel, ins=ins):
            return [moved_steps(btopo, benv, bmodel, ins, e, dt)
                    for dt in (torch.float64, torch.float32)]

        e, fails = gate_big(f"K1d {fam} {mode}", out, plain32, plain64,
                            moved)
        k1d_errs[f"{fam}_{mode}"] = e
        k1d_fails += fails
        k1d_err[fam] = max(k1d_err.get(fam, 0.0), *e["kernel_vs_plain64"])
    done("k1d_vs_plain", **k1d_errs, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL)
    if k1d_fails:
        raise RuntimeError("; ".join(k1d_fails))

    phase("k2_big", f"(B={B_CHECK}, the same draws: K2 head + tail on the "
                    "big trees vs K1d at (2, 2))")
    k2_big = {}
    for (fam, mode), (btopo, benv, bmodel, qpos, qvel, act, tb) in \
            big_draws.items():
        split = K2.ControlStepSplit(btopo, benv, bmodel, 2)
        reset_counts()
        qh, vh, X = split.head(qpos, qvel, act, tb, 1.0)
        q2, v2 = split.tail(qh, vh, act, tb, X, 1.0)
        if counts() != expect(1, f"k2big_head_{fam}", f"k2big_tail_{fam}"):
            raise RuntimeError(f"K2 {fam} {mode}: launches not counted")
        q1, v1 = CS.ControlStep(btopo, benv, bmodel, (2, 2))(
            qpos, qvel, act, tb, 1.0)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (q2, v2, X)):
            raise RuntimeError(f"K2 {fam} {mode}: output not finite")
        if not (torch.equal(q1, q2) and torch.equal(v1, v2)):
            raise RuntimeError(
                f"K2 {fam} {mode}: head + tail differ from K1d at (2, 2): "
                f"|dqpos| {(q1 - q2).abs().max().item()}, |dqvel| "
                f"{(v1 - v2).abs().max().item()}")
        ins64 = [t.double() for t in (qpos, qvel, act, tb)]
        qh64, vh64, X64 = K2.head_reference(btopo, benv,
                                            double_model(bmodel), *ins64,
                                            1.0, 2)
        scale = X64.abs().amax((2, 3), keepdim=True)
        k2_big[f"{fam}_{mode}"] = {
            "split_equals_k1d": True,
            "head_vs_plain64": [(qh.double() - qh64).abs().max().item(),
                                (vh.double() - vh64).abs().max().item()],
            "head_X_vs_plain64": [(X.double() - X64).abs().max().item(),
                                  ((X.double() - X64).abs() / scale).max()
                                  .item()]}
        k2_err[f"head_{fam}"] = max(k2_err.get(f"head_{fam}", 0.0),
                                    *k2_big[f"{fam}_{mode}"][
                                        "head_vs_plain64"])
    done("k2_big", **k2_big)

    phase("k1f", f"(B={B_CHECK}, explicit RFC without a gate, with the "
                 "height and the ground gate, per-joint meta-PD, both; one "
                 f"env in {K1F_LOWERED} lowered {K1F_SINK} m)")
    k1f_errs, k1f_fails = k1f_check(topo, model, lib,
                                    torch.Generator().manual_seed(15), dev)
    done("k1f", **k1f_errs, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL)
    if k1f_fails:
        raise RuntimeError("; ".join(k1f_fails))

    phase("k1f_big", f"(B={B_CHECK}, K1f on SMPL-H and masterfoot, "
                     f"{', '.join(K1F_BIG_MODES)}, (2, 2); one env in "
                     f"{K1F_LOWERED} lowered {K1F_SINK} m)")
    k1f_big_errs, k1f_big_fails = k1f_big_check(k1f_big_draws(dev))
    done("k1f_big", **k1f_big_errs, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL)
    if k1f_big_fails:
        raise RuntimeError("; ".join(k1f_big_fails))

    phase("k1g", f"(B={B_CHECK}, refresh_at={REFRESH_AT}: K1 at (1, 1) on "
                 "the kernel_vs_plain draws, K1d at (2, 2) on the SMPL-H "
                 "plain-PD draws of k1d_vs_plain)")
    k1g_errs, k1g_fails = {}, []
    for mode, (env_cfg, qpos, qvel, act, tb) in draws.items():
        k1g_errs[mode], fails, _ = k1g_check(topo, env_cfg, model,
                                             (qpos, qvel, act, tb), (1, 1))
        k1g_fails += fails
    btopo, benv, bmodel, *ins = big_draws["smplh", "plain_pd"]
    k1g_errs["smplh_plain_pd"], fails, _ = k1g_check(btopo, benv, bmodel,
                                                     ins, (2, 2), "smplh")
    k1g_fails += fails
    done("k1g", **k1g_errs, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL,
         pcg8_qpos_tol=SCHED_QPOS_TOL, pcg8_qvel_tol=SCHED_QVEL_TOL)
    if k1g_fails:
        raise RuntimeError("; ".join(k1g_fails))

    phase("eval", "(all clips, full length, seeded weights, kernel)")
    from uhc_tpu_torch.cli.eval import run_eval

    reset_counts()
    res = run_eval("sample_data/gait_clips.pkl", device=dev, seed=0)
    eval_counts = counts()
    launches = eval_counts["k1"]
    traj = res["traj"]
    S, T = len(keys), res["control_steps"]
    if eval_counts != expect(T, "k1"):
        raise RuntimeError(f"eval launched {eval_counts} for {T} control "
                           f"steps")
    if tuple(traj["pred_qpos"].shape) != (S, T, 76) or not bool(
            torch.isfinite(traj["pred_qpos"]).all()):
        raise RuntimeError("eval trajectory has the wrong shape or is not "
                           "finite")
    if not all(np.isfinite(v) for v in res["summary"].values()):
        raise RuntimeError(f"eval summary not finite: {res['summary']}")
    done("eval", launches=launches, control_steps=T,
         ms_per_step=res["ms_per_step"], summary=res["summary"])

    phase("eval_shape", "(uhc_implicit_shape, 8 bodies, full length, "
                        "seeded weights, K1e)")
    reset_counts()
    res_s = run_eval(SHAPE_CLIPS, device=dev, seed=0,
                     cfg="uhc_implicit_shape")
    shape_counts = counts()
    T_s = res_s["control_steps"]
    if shape_counts != expect(T_s, "k1e"):
        raise RuntimeError(f"eval_shape launched {shape_counts} for {T_s} "
                           f"control steps")
    if tuple(res_s["traj"]["pred_qpos"].shape) != (8, T_s, 76) or not bool(
            torch.isfinite(res_s["traj"]["pred_qpos"]).all()):
        raise RuntimeError("eval_shape trajectory has the wrong shape or is "
                           "not finite")
    if not all(np.isfinite(v) for v in res_s["summary"].values()) or not {
            "penetration", "skate"} <= set(res_s["summary"]):
        raise RuntimeError(f"eval_shape summary: {res_s['summary']}")
    done("eval_shape", launches=shape_counts["k1e"], control_steps=T_s,
         ms_per_step=res_s["ms_per_step"], summary=res_s["summary"])

    phase("eval_explicit", "(the explicit config, all gait clips, full "
                           "length, seeded weights, K1f)")
    from uhc_tpu_torch.config.config import EXPLICIT, META_JOINT

    reset_counts()
    res_x = run_eval("sample_data/gait_clips.pkl", device=dev, seed=0,
                     cfg=Config.from_dict("explicit", EXPLICIT))
    explicit_counts = counts()
    T_x = res_x["control_steps"]
    if explicit_counts != expect(T_x, "k1f"):
        raise RuntimeError(f"eval_explicit launched {explicit_counts} for "
                           f"{T_x} control steps")
    if tuple(res_x["traj"]["pred_qpos"].shape) != (S, T_x, 76) or not bool(
            torch.isfinite(res_x["traj"]["pred_qpos"]).all()):
        raise RuntimeError("eval_explicit trajectory has the wrong shape or "
                           "is not finite")
    if not all(np.isfinite(v) for v in res_x["summary"].values()):
        raise RuntimeError(f"eval_explicit summary: {res_x['summary']}")
    done("eval_explicit", launches=explicit_counts["k1f"],
         control_steps=T_x, ms_per_step=res_x["ms_per_step"],
         summary=res_x["summary"])

    train_counts = {}
    for train_phase, lane, epochs in (("train_lane", None, 3),
                                      ("train_split", "0", 2)):
        phase(train_phase, f"(cli/train, 1024 envs × 48 steps, {epochs} "
                           f"epochs, UHC_TPU_LANE={lane or 'unset'})")
        train_counts[train_phase] = run_train(lane, epochs, train_phase, dev)
    for train_phase, lane, epochs, args in (
            ("train_shape", None, 3, SHAPE_TRAIN_ARGS),
            ("train_shape_split", "0", 2, SHAPE_TRAIN_ARGS),
            ("train_dr", None, 2, DR_TRAIN_ARGS)):
        phase(train_phase, f"(cli/train {' '.join(args[:-1])}, {epochs} "
                           f"epochs, UHC_TPU_LANE={lane or 'unset'})")
        train_counts[train_phase] = run_train(lane, epochs, train_phase, dev,
                                              args, per_env=True)

    phase("train_smplh", "(cli/train --robot-model smplh, 512 envs × 32 "
                         "steps, 2 epochs through K1d with the eval at the "
                         "checkpoint)")
    train_counts["train_smplh"] = run_train(
        None, 2, "train_smplh", dev, SMPLH_TRAIN_ARGS,
        routed=("k1d_smplh",))
    phase("train_smplh_split", "(the same, 1 epoch through K2, "
                               "UHC_TPU_LANE_BIG=0)")
    train_counts["train_smplh_split"] = run_train(
        None, 1, "train_smplh_split", dev,
        SMPLH_TRAIN_ARGS + ["--no-train-eval"],
        routed=("k2big_head_smplh", "k2big_tail_smplh"), lane_big="0")

    phase("train_masterfoot", "(CopycatAgent with env.masterfoot=True, 512 "
                              "envs × 32 steps, 2 epochs through K1d)")

    def masterfoot_agent(out, mcfg=None):
        from uhc_tpu_torch.learn.agent import CopycatAgent

        mcfg = mcfg or Config.uhc_implicit()
        mcfg = dataclasses.replace(mcfg, env=dataclasses.replace(
            mcfg.env, masterfoot=True))
        return CopycatAgent(mcfg, "sample_data/gait_clips.pkl",
                            num_envs=512, horizon=32, results_dir=out,
                            device=dev)

    train_counts["train_masterfoot"] = run_train(
        None, 2, "train_masterfoot", dev, routed=("k1d_masterfoot",),
        agent_fn=masterfoot_agent)
    phase("train_masterfoot_split", "(the same, 1 epoch through K2, "
                                    "UHC_TPU_LANE_BIG=0)")
    train_counts["train_masterfoot_split"] = run_train(
        None, 1, "train_masterfoot_split", dev,
        routed=("k2big_head_masterfoot", "k2big_tail_masterfoot"),
        lane_big="0", agent_fn=masterfoot_agent)

    for train_phase, name, cfg_dict in (
            ("train_explicit", "explicit", EXPLICIT),
            ("train_meta_joint", "meta_joint", META_JOINT)):
        phase(train_phase, f"(CopycatAgent with the {name} config, 1024 "
                           "envs × 48 steps, 2 epochs through K1f)")

        def k1f_agent(out, name=name, cfg_dict=cfg_dict):
            from uhc_tpu_torch.learn.agent import CopycatAgent

            return CopycatAgent(Config.from_dict(name, cfg_dict),
                                "sample_data/gait_clips.pkl", num_envs=1024,
                                horizon=48, results_dir=out, device=dev)

        train_counts[train_phase] = run_train(
            None, 2, train_phase, dev, routed=("k1f",), agent_fn=k1f_agent)

    # K1f on the big trees: SMPL-H through cli/train (explicit with the
    # eval at the checkpoint), masterfoot through the agent; the other
    # config on each tree for one epoch, and explicit SMPL-H under
    # UHC_TPU_LANE_BIG=0 on the plain chain, where the JAX package runs XLA
    for train_phase, name, epochs, lane_big in (
            ("train_smplh_explicit", "explicit", 2, None),
            ("train_smplh_meta_joint", "meta_joint", 1, None),
            ("train_smplh_explicit_plain", "explicit", 1, "0")):
        args = ["--cfg", name] + SMPLH_TRAIN_ARGS + (
            [] if train_phase == "train_smplh_explicit"
            else ["--no-train-eval"])
        phase(train_phase, f"(cli/train {' '.join(args)}, {epochs} epochs, "
                           f"UHC_TPU_LANE_BIG={lane_big or 'unset'}: "
                           f"{'the plain chain' if lane_big else 'K1f'})")
        train_counts[train_phase] = run_train(
            None, epochs, train_phase, dev, args, lane_big=lane_big,
            routed=() if lane_big else ("k1f_smplh",))
    for train_phase, name, cfg_dict, epochs in (
            ("train_masterfoot_meta_joint", "meta_joint", META_JOINT, 2),
            ("train_masterfoot_explicit", "explicit", EXPLICIT, 1)):
        phase(train_phase, f"(CopycatAgent with env.masterfoot=True under "
                           f"the {name} config, 512 envs × 32 steps, "
                           f"{epochs} epochs through K1f)")
        train_counts[train_phase] = run_train(
            None, epochs, train_phase, dev, routed=("k1f_masterfoot",),
            agent_fn=lambda out, name=name, cfg_dict=cfg_dict:
            masterfoot_agent(out, Config.from_dict(name, cfg_dict)))

    phase("time", f"(B={B_TIME}, uhc_implicit control step)")
    step = CS.ControlStep(topo, cfg.env, model, pcg_iters=(1, 2))
    qpos, qvel, tb = draw_states(lib, B_TIME, gen, dev)
    act = (0.02 * torch.randn((B_TIME, step.act_dim),
                              generator=gen)).to(dev)
    n0 = CS.LAUNCHES["step", 24, False]
    step(qpos, qvel, act, tb, 1.0)
    torch.cuda.synchronize()
    kernel_ms = cuda_ms(lambda: step(qpos, qvel, act, tb, 1.0), 10)
    trace = []
    from uhc_tpu_torch.physics import solver as SV

    SV.do_simulation(topo, cfg.env, model, qpos, qvel, act, tb, 1.0, (1, 2),
                     trace=trace)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: CS.control_step_reference(
        topo, cfg.env, model, qpos, qvel, act, tb, 1.0, (1, 2)), 2)
    flops = CS.control_step_flops(topo, cfg.env, trace, (1, 2))
    nbytes = 4 * (qpos.numel() * 2 + qvel.numel() * 2 + act.numel()
                  + tb.numel() + step.params.size + step.itab.size)
    bound_ms = 1e3 * max(flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S)
    bound_by = ("operations" if flops / H100_F32_FLOPS
                >= nbytes / H100_BYTES_PER_S else "bytes")

    # the full batched env step: obs + policy + kernel + reward
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.smpl.constants import default_diff_weights

    obs_dim = H.obs_dim(topo, cfg.env)
    policy = nets.policy_mcp_init(obs_dim, step.act_dim, cfg.policy_hsize,
                                  cfg.composer_dim, cfg.num_primitive,
                                  torch.Generator().manual_seed(1),
                                  cfg.policy_htype, dev)
    rs = RN.RunningStats(torch.tensor(2.0, device=dev),
                         torch.zeros(obs_dim, device=dev),
                         torch.ones(obs_dim, device=dev))
    jpw, bdw = default_diff_weights()
    jpw = torch.as_tensor(jpw, device=dev)
    bdw = torch.as_tensor(bdw, device=dev)
    seq = torch.arange(B_TIME, device=dev) % S
    start = torch.randint(0, int(lib["len"].min()) - 30, (B_TIME,),
                          generator=gen).to(dev)
    states = H.env_reset(topo, model, cfg.env, seq, lib, lib["qpos"][0, 0],
                         lib["qvel"][0, 0], start_ind=start, train=False)
    env_step = H.make_env_step_batched(topo, cfg.env, fused_model=model)

    def one_env_step(st):
        with torch.no_grad():
            obs = H.get_obs(topo, model, cfg.env, st, lib)
            a = policy(RN.normalize(rs, obs))
            return env_step(model, st, a, lib, jpw, bdw, train=False)[0]

    states = one_env_step(states)
    torch.cuda.synchronize()
    n_env = 5
    t0 = time.perf_counter()
    for _ in range(n_env):
        states = one_env_step(states)
    torch.cuda.synchronize()
    env_s = time.perf_counter() - t0
    if not bool(torch.isfinite(states.qpos).all()):
        raise RuntimeError("batched env step produced non-finite qpos")
    timed_launches = CS.LAUNCHES["step", 24, False] - n0

    # K2 at the same inputs: head and tail timed apart
    split = K2.ControlStepSplit(topo, cfg.env, model, 2)
    qh, vh, X = split.head(qpos, qvel, act, tb, 1.0)
    split.tail(qh, vh, act, tb, X, 1.0)
    torch.cuda.synchronize()
    head_ms = cuda_ms(lambda: split.head(qpos, qvel, act, tb, 1.0), 10)
    tail_ms = cuda_ms(lambda: split.tail(qh, vh, act, tb, X, 1.0), 10)
    trace2 = []
    SV.do_simulation(topo, cfg.env, model, qpos, qvel, act, tb, 1.0, (2, 2),
                     trace=trace2)
    plain_head_ms = cuda_ms(lambda: K2.head_reference(
        topo, cfg.env, model, qpos, qvel, act, tb, 1.0, 2), 2)
    plain_tail_ms = cuda_ms(lambda: K2.tail_reference(
        topo, cfg.env, model, qh, vh, act, tb, X, 1.0, 2), 2)
    tables = step.params.size + step.itab.size
    state_io = (qpos.numel() * 2 + qvel.numel() * 2 + act.numel()
                + tb.numel() + tables)
    k2_bound = {}
    for part, active, start in (("head", trace2[:1], 0),
                                ("tail", trace2[1:], 1)):
        fl = CS.control_step_flops(topo, cfg.env, active, (2, 2), start)
        by = 4 * (state_io + X.numel())
        t_op, t_by = fl / H100_F32_FLOPS, by / H100_BYTES_PER_S
        k2_bound[part] = {"flops": fl, "bytes": by,
                          "bound_ms": 1e3 * max(t_op, t_by),
                          "bound_by": "operations" if t_op >= t_by
                          else "bytes"}
    done("time", kernel_ms=kernel_ms, plain_ms=plain_ms,
         substeps_per_s=B_TIME * cfg.env.frame_skip / (kernel_ms / 1e3),
         flops_per_step=flops, bound_ms=bound_ms, bound_by=bound_by,
         env_steps_per_s=B_TIME * n_env / env_s,
         env_step_ms=1e3 * env_s / n_env, timed_launches=timed_launches,
         k2_head_ms=head_ms, k2_tail_ms=tail_ms,
         k2_plain_head_ms=plain_head_ms, k2_plain_tail_ms=plain_tail_ms,
         k2_bound=k2_bound, card=smi)

    # K1e over the shaped library beside K1 (the shared stand-in) on the
    # same states, uhc_implicit_shape's meta-PD control step, timed in
    # turns K1, K1e, K1e, K1; K2 over the library at (2, 2)
    from uhc_tpu_torch.physics.model import model_gather

    shape_env = Config.uhc_implicit_shape().env
    gen_t = torch.Generator().manual_seed(12)
    qe, ve, tbe, seqe = draw_lib_states(slib, B_TIME, gen_t, dev)
    k1s = CS.ControlStep(topo, shape_env, model, pcg_iters=(1, 2))
    k1e = CS.ControlStep(topo, shape_env, smodel, pcg_iters=(1, 2))
    acte = (0.02 * torch.randn((B_TIME, k1e.act_dim),
                               generator=gen_t)).to(dev)
    k1s(qe, ve, acte, tbe, 1.0)
    k1e(qe, ve, acte, tbe, 1.0, seqe)
    torch.cuda.synchronize()
    turns = []
    for which in ("k1", "k1e", "k1e", "k1"):
        turns.append(cuda_ms(
            (lambda: k1s(qe, ve, acte, tbe, 1.0)) if which == "k1" else
            (lambda: k1e(qe, ve, acte, tbe, 1.0, seqe)), 10))
    k1e_ms = 0.5 * (turns[1] + turns[2])
    k1_same_ms = 0.5 * (turns[0] + turns[3])
    # the gather alone: K1e over a library whose 8 rows all equal the
    # shared model, beside K1, same states and turns
    k1e_same = CS.ControlStep(topo, shape_env, dataclasses.replace(
        model, body_pos=model.body_pos.expand(8, -1, -1).clone()), (1, 2))
    turns_eq = []
    for which in ("k1", "k1e", "k1e", "k1"):
        turns_eq.append(cuda_ms(
            (lambda: k1s(qe, ve, acte, tbe, 1.0)) if which == "k1" else
            (lambda: k1e_same(qe, ve, acte, tbe, 1.0, seqe)), 10))
    plain_e_ms = cuda_ms(lambda: CS.control_step_reference(
        topo, shape_env, smodel, qe, ve, acte, tbe, 1.0, (1, 2), seqe), 2)
    gathered = model_gather(smodel, seqe.long())
    trace_e, trace_e2, trace_s = [], [], []
    SV.do_simulation(topo, shape_env, gathered, qe, ve, acte, tbe, 1.0,
                     (1, 2), trace=trace_e)
    SV.do_simulation(topo, shape_env, model, qe, ve, acte, tbe, 1.0,
                     (1, 2), trace=trace_s)
    SV.do_simulation(topo, shape_env, gathered, qe, ve, acte, tbe, 1.0,
                     (2, 2), trace=trace_e2)
    lib_tables = k1e.params.size + k1e.itab.size + B_TIME    # + seq_idx
    io_e = (qe.numel() * 2 + ve.numel() * 2 + acte.numel() + tbe.numel()
            + lib_tables)

    def bound(fl, nbytes):
        t_op, t_by = fl / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
        return {"flops": fl, "bytes": nbytes,
                "bound_ms": 1e3 * max(t_op, t_by),
                "bound_by": "operations" if t_op >= t_by else "bytes"}

    k1e_bound = bound(CS.control_step_flops(topo, shape_env, trace_e,
                                            (1, 2)), 4 * io_e)
    split_e = K2.ControlStepSplit(topo, shape_env, smodel, 2)
    qhe, vhe, Xe = split_e.head(qe, ve, acte, tbe, 1.0, seqe)
    split_e.tail(qhe, vhe, acte, tbe, Xe, 1.0, seqe)
    torch.cuda.synchronize()
    head_e_ms = cuda_ms(lambda: split_e.head(qe, ve, acte, tbe, 1.0, seqe),
                        10)
    tail_e_ms = cuda_ms(lambda: split_e.tail(qhe, vhe, acte, tbe, Xe, 1.0,
                                             seqe), 10)
    plain_head_e_ms = cuda_ms(lambda: K2.head_reference(
        topo, shape_env, smodel, qe, ve, acte, tbe, 1.0, 2, seqe), 2)
    plain_tail_e_ms = cuda_ms(lambda: K2.tail_reference(
        topo, shape_env, smodel, qhe, vhe, acte, tbe, Xe, 1.0, 2, seqe), 2)
    k2e_bound = {
        part: bound(CS.control_step_flops(topo, shape_env, act, (2, 2), st),
                    4 * (io_e + Xe.numel()))
        for part, act, st in (("head", trace_e2[:1], 0),
                              ("tail", trace_e2[1:], 1))}
    done("time_per_env", k1e_ms=k1e_ms, k1_same_states_ms=k1_same_ms,
         turns_k1_k1e_k1e_k1=turns, k1e_over_k1=k1e_ms / k1_same_ms,
         turns_k1_k1e_equal_rows=turns_eq,
         k1e_equal_rows_over_k1=(turns_eq[1] + turns_eq[2])
         / (turns_eq[0] + turns_eq[3]),
         k1_same_states_flops=CS.control_step_flops(topo, shape_env,
                                                    trace_s, (1, 2)),
         k1e_plain_ms=plain_e_ms, k1e_bound=k1e_bound,
         k2e_head_ms=head_e_ms, k2e_tail_ms=tail_e_ms,
         k2e_plain_head_ms=plain_head_e_ms,
         k2e_plain_tail_ms=plain_tail_e_ms, k2e_bound=k2e_bound,
         library_rows=k1e.num_models, card=smi)

    phase("time_big", f"(K1d and K2 on SMPL-H and masterfoot, uhc_implicit, "
                      f"B={B_BIG_TIME}; plain versions at B={B_BIG_TIME[0]})")
    gen_b = torch.Generator().manual_seed(14)
    big_time = {}
    for fam, nb in BIG:
        btopo, benv, bmodel, blib = big_tree(fam, dev)
        k1d = CS.ControlStep(btopo, benv, bmodel, (2, 2))
        split = K2.ControlStepSplit(btopo, benv, bmodel, 2)
        per_env_ws = build.layout(k1d.library())["workspace"]
        row = {"bodies": nb, "nv": btopo.nv}
        for B in B_BIG_TIME:
            qpos, qvel, tb = draw_big_states(blib, btopo.nv, B, gen_b, dev)
            act = (0.02 * torch.randn((B, k1d.act_dim),
                                      generator=gen_b)).to(dev)
            k1d(qpos, qvel, act, tb, 1.0)
            qh, vh, X = split.head(qpos, qvel, act, tb, 1.0)
            split.tail(qh, vh, act, tb, X, 1.0)
            torch.cuda.synchronize()
            reps = 5 if B >= 2048 else 10
            t = {"k1d_ms": cuda_ms(lambda: k1d(qpos, qvel, act, tb, 1.0),
                                   reps),
                 "head_ms": cuda_ms(lambda: split.head(qpos, qvel, act, tb,
                                                       1.0), reps),
                 "tail_ms": cuda_ms(lambda: split.tail(qh, vh, act, tb, X,
                                                       1.0), reps)}
            trace = []
            SV.do_simulation(btopo, benv, bmodel, qpos, qvel, act, tb, 1.0,
                             (2, 2), trace=trace)
            state_io = (qpos.numel() * 2 + qvel.numel() * 2 + act.numel()
                        + tb.numel() + k1d.params.size + k1d.itab.size)
            t["bound"] = {part: bound(CS.control_step_flops(
                btopo, benv, tr, (2, 2), st), 4 * (state_io + extra))
                for part, tr, st, extra in (
                    ("k1d", trace, 0, 0), ("head", trace[:1], 0, X.numel()),
                    ("tail", trace[1:], 1, X.numel()))}
            # the implementation's own traffic, apart from the bound: the
            # matrix workspace written and read back once a substep
            ws_bytes = 2 * benv.frame_skip * B * per_env_ws * 4
            t["workspace_bytes"] = ws_bytes
            t["workspace_ms_at_hbm_rate"] = 1e3 * ws_bytes / H100_BYTES_PER_S
            t["substeps_per_s"] = B * benv.frame_skip / (t["k1d_ms"] / 1e3)
            if B == B_BIG_TIME[0]:
                t["plain_ms"] = cuda_ms(lambda: CS.control_step_reference(
                    btopo, benv, bmodel, qpos, qvel, act, tb, 1.0, (2, 2)),
                    1)
                t["plain_head_ms"] = cuda_ms(lambda: K2.head_reference(
                    btopo, benv, bmodel, qpos, qvel, act, tb, 1.0, 2), 1)
                t["plain_tail_ms"] = cuda_ms(lambda: K2.tail_reference(
                    btopo, benv, bmodel, qh, vh, act, tb, X, 1.0, 2), 1)
            row[f"B{B}"] = t
        train_phase = "train_smplh" if fam == "smplh" else "train_masterfoot"
        row["train"] = TRAIN_RATES[train_phase]
        row["train_split"] = TRAIN_RATES[train_phase + "_split"]
        big_time[fam] = row
    done("time_big", **big_time, card=smi)

    phase("time_k1f", f"(B={B_TIME}, K1f in the explicit and meta_joint "
                      "modes beside K1 on the same states, in turns K1, "
                      "K1f, K1f, K1)")
    gen_f = torch.Generator().manual_seed(16)
    k1 = CS.ControlStep(topo, cfg.env, model, pcg_iters=(1, 2))
    k1f_time = {}
    for mode in ("explicit", "meta_joint"):
        env_cfg = k1f_modes()[mode]
        k1f = CS.ControlStep(topo, env_cfg, model, pcg_iters=(1, 2))
        qpos, qvel, actf, tb = k1f_draw(topo, env_cfg, lib, B_TIME, gen_f,
                                        dev)
        act1 = actf[:, :k1.act_dim].contiguous()    # the same PD targets
        k1(qpos, qvel, act1, tb, 1.0)
        k1f(qpos, qvel, actf, tb, 1.0)
        torch.cuda.synchronize()
        turns = [cuda_ms((lambda: k1(qpos, qvel, act1, tb, 1.0))
                         if which == "k1" else
                         (lambda: k1f(qpos, qvel, actf, tb, 1.0)), 10)
                 for which in ("k1", "k1f", "k1f", "k1")]
        trace = []
        SV.do_simulation(topo, env_cfg, model, qpos, qvel, actf, tb, 1.0,
                         (1, 2), trace=trace)
        vfx, gains = CS.k1f_operands(topo, env_cfg, model, actf)
        operands = sum(x.numel() for x in (vfx, gains) if x is not None)
        io = (qpos.numel() * 2 + qvel.numel() * 2 + actf.numel()
              + tb.numel() + k1f.params.size + k1f.itab.size + operands)
        k1f_time[mode] = {
            "k1f_ms": 0.5 * (turns[1] + turns[2]),
            "k1_same_states_ms": 0.5 * (turns[0] + turns[3]),
            "turns_k1_k1f_k1f_k1": turns,
            "plain_ms": cuda_ms(lambda: CS.control_step_reference(
                topo, env_cfg, model, qpos, qvel, actf, tb, 1.0, (1, 2)), 2),
            "bound": bound(CS.control_step_flops(topo, env_cfg, trace,
                                                 (1, 2)), 4 * io),
            "act_dim": k1f.act_dim, "operand_floats_per_env": operands
            // B_TIME}
        k1f_time[mode]["k1f_over_k1"] = (k1f_time[mode]["k1f_ms"]
                                         / k1f_time[mode]["k1_same_states_ms"])
        k1f_time[mode]["train"] = TRAIN_RATES.get(f"train_{mode}")
    done("time_k1f", **k1f_time, card=smi)

    phase("time_k1f_big", f"(K1f explicit and meta_joint on SMPL-H and "
                          f"masterfoot, B={B_BIG_TIME}, beside K1d on the "
                          "same states in turns K1d, K1f, K1f, K1d; plain "
                          f"versions at B={B_BIG_TIME[0]})")
    gen_fb = torch.Generator().manual_seed(18)
    k1f_big_time = {}
    for fam, nb in BIG:
        btopo, benv, bmodel, blib = big_tree(fam, dev)
        k1d = CS.ControlStep(btopo, benv, bmodel, (2, 2))
        k1f_big_time[fam] = {}
        for mode in ("explicit", "meta_joint"):
            env_cfg = on_tree(k1f_modes()[mode], fam)
            k1f = CS.ControlStep(btopo, env_cfg, bmodel, (2, 2))
            row = {"act_dim": k1f.act_dim,
                   "kept_action_columns": CS.kept_action_columns(btopo,
                                                                 env_cfg)}
            for B in B_BIG_TIME:
                qpos, qvel, actf, tb = k1f_draw(btopo, env_cfg, blib, B,
                                                gen_fb, dev)
                act1 = actf[:, :k1d.act_dim].contiguous()
                k1d(qpos, qvel, act1, tb, 1.0)
                k1f(qpos, qvel, actf, tb, 1.0)
                torch.cuda.synchronize()
                reps = 5 if B >= 2048 else 10
                turns = [cuda_ms((lambda: k1d(qpos, qvel, act1, tb, 1.0))
                                 if which == "k1d" else
                                 (lambda: k1f(qpos, qvel, actf, tb, 1.0)),
                                 reps)
                         for which in ("k1d", "k1f", "k1f", "k1d")]
                trace = []
                SV.do_simulation(btopo, env_cfg, bmodel, qpos, qvel, actf, tb,
                                 1.0, (2, 2), trace=trace)
                vfx, gains = CS.k1f_operands(btopo, env_cfg, bmodel, actf)
                operands = sum(x.numel() for x in (vfx, gains)
                               if x is not None)
                io = (qpos.numel() * 2 + qvel.numel() * 2 + actf.numel()
                      + tb.numel() + k1f.params.size + k1f.itab.size
                      + operands)
                t = {"k1f_ms": 0.5 * (turns[1] + turns[2]),
                     "k1d_same_states_ms": 0.5 * (turns[0] + turns[3]),
                     "turns_k1d_k1f_k1f_k1d": turns,
                     "bound": bound(CS.control_step_flops(
                         btopo, env_cfg, trace, (2, 2)), 4 * io),
                     "operand_floats_per_env": operands // B}
                t["k1f_over_k1d"] = t["k1f_ms"] / t["k1d_same_states_ms"]
                if B == B_BIG_TIME[0]:
                    t["plain_ms"] = cuda_ms(
                        lambda: CS.control_step_reference(
                            btopo, env_cfg, bmodel, qpos, qvel, actf, tb,
                            1.0, (2, 2)), 1)
                row[f"B{B}"] = t
            row["train"] = TRAIN_RATES.get(f"train_{fam}_{mode}")
            k1f_big_time[fam][mode] = row
    done("time_k1f_big", **k1f_big_time, card=smi)

    phase("time_k1g", f"(B={B_TIME}, uhc_implicit: {K1G_CHAIN} control steps "
                      f"through K1 with refresh_at={REFRESH_AT} at (1, 1), "
                      "the state fed back as bench.py does; then K1g beside "
                      "K1 at (1, 1) in turns K1, K1g, K1g, K1)")
    gen_g = torch.Generator().manual_seed(19)
    k1g = CS.ControlStep(topo, cfg.env, model, (1, 1), refresh_at=REFRESH_AT)
    k1_11 = CS.ControlStep(topo, cfg.env, model, (1, 1))
    qpos, qvel, tb = draw_states(lib, B_TIME, gen_g, dev)
    act = (0.02 * torch.randn((B_TIME, k1g.act_dim), generator=gen_g)).to(dev)
    reset_counts()
    qc, vc = qpos, qvel
    for _ in range(K1G_CHAIN):
        qc, vc = k1g(qc, vc, act, tb, 1.0)
    torch.cuda.synchronize()
    k1g_chain = counts()
    if k1g_chain != expect(K1G_CHAIN, "k1g") or not bool(
            torch.isfinite(qc).all() & torch.isfinite(vc).all()):
        raise RuntimeError(f"time_k1g: launches {k1g_chain} for {K1G_CHAIN} "
                           "control steps, or the state is not finite")
    turns = [cuda_ms((lambda: k1_11(qpos, qvel, act, tb, 1.0))
                     if which == "k1" else
                     (lambda: k1g(qpos, qvel, act, tb, 1.0)), 10)
             for which in ("k1", "k1g", "k1g", "k1")]
    trace = []
    SV.do_simulation(topo, cfg.env, model, qpos, qvel, act, tb, 1.0, (1, 1),
                     trace=trace, refresh_at=REFRESH_AT)
    io = (qpos.numel() * 2 + qvel.numel() * 2 + act.numel() + tb.numel()
          + k1g.params.size + k1g.itab.size)
    k1g_time = {
        "chain_launches": k1g_chain["k1g"],
        "chain_final_height": [qc[:, 2].min().item(), qc[:, 2].max().item()],
        "k1g_ms": 0.5 * (turns[1] + turns[2]),
        "k1_11_same_states_ms": 0.5 * (turns[0] + turns[3]),
        "turns_k1_k1g_k1g_k1": turns,
        "plain_ms": cuda_ms(lambda: CS.control_step_reference(
            topo, cfg.env, model, qpos, qvel, act, tb, 1.0, (1, 1),
            refresh_at=REFRESH_AT), 2),
        "bound": bound(CS.control_step_flops(topo, cfg.env, trace, (1, 1),
                                             refresh_at=REFRESH_AT), 4 * io)}
    k1g_time["k1g_over_k1_11"] = (k1g_time["k1g_ms"]
                                  / k1g_time["k1_11_same_states_ms"])
    done("time_k1g", **k1g_time, card=smi)

    src = "uhc_tpu_torch/csrc/control_step.cu"
    k2_src = "uhc_tpu/physics/pallas_substep.py:284"
    print(json.dumps({"kernels": [
        {"name": "control_step", "route": "cuda", "source": src,
         "replaces": "uhc_tpu/physics/pallas_lane.py:83",
         "launches": launches + train_counts["train_lane"]["k1"],
         "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None},
        {"name": "control_step_head", "route": "cuda", "source": src,
         "replaces": k2_src,
         "launches": train_counts["train_split"]["k2_head"],
         "max_abs_err": k2_err["head"], "ms": head_ms,
         "plain_ms": plain_head_ms, "bound_ms": k2_bound["head"]["bound_ms"],
         "bound_by": k2_bound["head"]["bound_by"], "library_ms": None},
        {"name": "control_step_tail", "route": "cuda", "source": src,
         "replaces": k2_src,
         "launches": train_counts["train_split"]["k2_tail"],
         "max_abs_err": k2_err["tail"], "ms": tail_ms,
         "plain_ms": plain_tail_ms, "bound_ms": k2_bound["tail"]["bound_ms"],
         "bound_by": k2_bound["tail"]["bound_by"], "library_ms": None},
        {"name": "control_step_per_env", "route": "cuda", "source": src,
         "replaces": "uhc_tpu/physics/pallas_lane.py:176",
         "launches": (shape_counts["k1e"] + train_counts["train_shape"]["k1e"]
                      + train_counts["train_dr"]["k1e"]),
         "max_abs_err": k1e_err, "ms": k1e_ms, "plain_ms": plain_e_ms,
         "bound_ms": k1e_bound["bound_ms"], "bound_by": k1e_bound["bound_by"],
         "library_ms": None},
        {"name": "control_step_head_per_env", "route": "cuda", "source": src,
         "replaces": k2_src,
         "launches": train_counts["train_shape_split"]["k2e_head"],
         "max_abs_err": k2_err["head_pe"], "ms": head_e_ms,
         "plain_ms": plain_head_e_ms,
         "bound_ms": k2e_bound["head"]["bound_ms"],
         "bound_by": k2e_bound["head"]["bound_by"], "library_ms": None},
        {"name": "control_step_tail_per_env", "route": "cuda", "source": src,
         "replaces": k2_src,
         "launches": train_counts["train_shape_split"]["k2e_tail"],
         "max_abs_err": k2_err["tail_pe"], "ms": tail_e_ms,
         "plain_ms": plain_tail_e_ms,
         "bound_ms": k2e_bound["tail"]["bound_ms"],
         "bound_by": k2e_bound["tail"]["bound_by"], "library_ms": None},
    ] + [row for fam, _ in BIG for row in big_rows(
        fam, src, k2_src, train_counts, k1d_err[fam], k2_err[f"head_{fam}"],
        big_time[fam])] + [
        {"name": f"control_step_{mode}", "route": "cuda", "source": src,
         "replaces": "uhc_tpu/physics/pallas_lane.py:127",
         "launches": launches_f,
         "max_abs_err": max(v for m, e in k1f_errs.items() if term in m
                            for k in ("kernel_vs_plain64",
                                      "kernel_vs_plain32") for v in e[k]),
         "ms": k1f_time[mode]["k1f_ms"],
         "plain_ms": k1f_time[mode]["plain_ms"],
         "bound_ms": k1f_time[mode]["bound"]["bound_ms"],
         "bound_by": k1f_time[mode]["bound"]["bound_by"], "library_ms": None}
        for mode, term, launches_f in (
            ("explicit", "explicit", explicit_counts["k1f"]
             + train_counts["train_explicit"]["k1f"]),
            ("meta_joint", "meta_joint",
             train_counts["train_meta_joint"]["k1f"]))] + [
        {"name": f"control_step_{mode}_{fam}", "route": "cuda",
         "source": src, "replaces": "uhc_tpu/physics/pallas_lane.py:127",
         "launches": train_counts[f"train_{fam}_{mode}"][f"k1f_{fam}"],
         "max_abs_err": max(v for m, e in k1f_big_errs.items()
                            if m.startswith(f"{fam}_{mode}")
                            for k in ("kernel_vs_plain64",
                                      "kernel_vs_plain32_sharp")
                            for v in e[k]),
         "ms": k1f_big_time[fam][mode][f"B{B_BIG_TIME[0]}"]["k1f_ms"],
         "plain_ms": k1f_big_time[fam][mode][f"B{B_BIG_TIME[0]}"][
             "plain_ms"],
         "bound_ms": k1f_big_time[fam][mode][f"B{B_BIG_TIME[0]}"]["bound"][
             "bound_ms"],
         "bound_by": k1f_big_time[fam][mode][f"B{B_BIG_TIME[0]}"]["bound"][
             "bound_by"], "library_ms": None}
        for fam, _ in BIG for mode in ("explicit", "meta_joint")] + [
        {"name": "control_step_refresh", "route": "cuda", "source": src,
         "replaces": "uhc_tpu/physics/pallas_lane.py:104",
         "launches": k1g_time["chain_launches"],
         "max_abs_err": max(v for m in draws for k in (
             "kernel_vs_plain64", "kernel_vs_plain32_sharp")
             for v in k1g_errs[m][k]),
         "ms": k1g_time["k1g_ms"], "plain_ms": k1g_time["plain_ms"],
         "bound_ms": k1g_time["bound"]["bound_ms"],
         "bound_by": k1g_time["bound"]["bound_by"], "library_ms": None}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(DEADLINE_S)
    try:
        return run()
    except BaseException as exc:  # noqa: BLE001 - every failure exits 1
        traceback.print_exc()
        # the reason goes to stdout too, beside the phase lines
        print(f"FAILED in phase {_phase[0]}: {exc!r}", flush=True)
        return 1
    finally:
        signal.alarm(0)


if __name__ == "__main__":
    sys.exit(main())
