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
eval at the checkpoint), K1g, the control step with a second exact
inverse pair at substep 8 (`refresh_at`), held against its plain versions
and a PCG-8 step on the 24-body tree and on SMPL-H and run as bench.py
runs its control steps, K2 on the 55-body SMPL-X (its own nvcc build,
held against its plain versions and its K1 build, and the env's rollout
of 512 envs × 32 steps through it), and K2b, the head/tail split with the
bfloat16 preconditioner (held against its plain versions, its one-launch
form and a PCG-8 step on the 24-body tree, SMPL-H and SMPL-X, and driven
through the port of tools/kernel_bench.py), the fit-and-eval protocol on
the repository's uhc_implicit_dyn19 run (cli/eval with --results-dir
--epoch 4000 --singles-dir over the 19 clips of gait_clips_ext.pkl, each
clip under its own policy where it has one, one K1 launch a control step,
the dump re-scored by cli/eval_imitation, and cli/fit on one clip
warm-started from iter_4000.p at 512 envs × 48 steps, once with its
windowed criterion and once with its full-sequence eval), PPO with a
trainable log-std (fix_std=False) and one TRPO update on its batch, the
obs families v0, v3, v4, v5 and v6 with the rewards
world_rfc_implicit_v1_mul, _v2, local_rfc_implicit, world_rfc_implicit_v3
and local_rfc_explicit (through K1, K1f under the explicit config), and
the transformer actor on obs v4's tokens, the models built from SMPL-H
and SMPL-X model data (seeded 52- and 55-joint files: `cli/train
--robot-model smplh --smpl-data` through K1d, the SMPL-X rollout through
K2-55, each kernel held against its plain versions on that model), K1e
over an exact-mass shaped library (hull mass properties per body, the
library's eval of the 8 shape clips), and the ball-joint family (`--cfg
ball`: training and the six-clip eval on the torque route, which runs no
kernel, and its step held against its plain versions), and remove_toe's
22-body tree (smpl/local_robot.py) through the -DNB=22 build of every
kernel (K1, K1f, K1e over a 2-model library and K2's head and tail, each
held against its plain versions and driven by the env's rollout of 512
envs × 32 steps), with K1 on the capsule and box_feet variants; K2's head
state is held on every tree -- checks their output, and times the kernels
at B=2048 (and the big trees' at B=512). A 32-body build is compiled and
sized only, the largest tree of the small-tree layout. Then the native
mesh toolkit (built with g++, the stand-in's meshes read and weighed both
ways), the kinematic-policy stack (one kin env step on the card held
against its plain versions, `cli/train --cfg uhm_1 --agent uhm` at 256
envs × 24 steps and `cli/eval_relive` of its checkpoint; the exact chain,
no kernel) and scene objects (a 512 × 32 rollout through K1 over a
library with an object track, K1 on its states, a dynamic box's control
step held against its plain versions, a box drop), and the
data-preparation and inspection tools (phase `tools`: a synthetic AMASS
directory of the gait clips, three corpora for the three splits, through
data/process_amass with grounding on the card, every clip's 30 Hz pose
equal to the gait clip's; `cli/eval --dump` over the train split through
K1 with the seeded full-width copycat; `cli/replay --list` and
`--dump-states`, whose arrays equal the dump's; render_eval_result's FK,
CameraFit's four losses, gradients and a 50-step descent over one gait
clip, and the model zoo at full width (SimpleCNN, ResNet features and
MobileNet at 224×224, VideoRegNet over 32 frames, TCN, ERD, CMLP, the
discriminator, the discrete policy), each held against the port on the
CPU; gather_windows on the device library; nothing is rendered on the
card, which has no matplotlib), and data-parallel training (phase
`data_parallel`: `cli/train --data-parallel`'s run as two ranks on one
card over gloo, 96 K1 launches a rank, every rank's parameters,
statistics and sampler equal bit for bit each epoch, rank 0's checkpoint
in a single-process agent; one PPO update of a fixed batch over the ranks
against one process; `cli/train --data-parallel` itself over NCCL where
there are two cards or more; a `--profile` run whose trace names
control_step_kernel).
Whatever the phases write goes to temporary directories.

Usage: python3 chip_smoke.py [--parent SRC] (needs one CUDA card).
With --parent, SRC is another version of
uhc_tpu_torch/csrc/control_step.cu (say the parent commit's, from `git
show HEAD~1:uhc_tpu_torch/csrc/control_step.cu`, or a copy of this one
with a constant changed), built beside this one for 24 bodies and the big
trees; phases time, time_per_env, time_k1f and time_k1g then time its K1
(at (1, 2), (2, 2) and (1, 1)), K2 head and tail, K2b (head, tail,
split=False), K1e, K1f (explicit, meta_joint) and K1g, and time_big and
time_k1f_big its K1d, K2, K2b and K1f-big, in turns with this checkout's
(parent, this, this, parent); they split each step as `time_split` does
and fail where the outputs are not equal bit for bit. A source older
than J6 and G stored by subtree is called through `OlderEntries`.

Phases print a line when they start and one with their numbers when they
end. Output ends with a JSON line of per-kernel numbers, the card's name
and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}} as the last line. Any failure, a missing
card, a missing repository or the deadline exits non-zero and prints no
result.
"""
import ctypes
import json
import os
import signal
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

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
# phase k2_big's draw for the big trees' heads: float32 arithmetic misses
# the float64 bounds after one substep on some 0.4 % of masterfoot's envs,
# so gate_big's count rule needs thousands of envs to tell two float32
# computations apart (PERF.md §2)
B_HEAD = 4096
TRAIN_ARGS = ["--num-envs", "1024", "--horizon", "48", "--no-train-eval"]
SHAPE_CLIPS = "sample_data/shape_clips.pkl"
# the shape run of the JAX package (tools/train_queue.sh:36-38)
SHAPE_TRAIN_ARGS = ["--cfg", "uhc_implicit_shape", "--motion-file",
                    SHAPE_CLIPS, "--num-envs", "1024", "--horizon", "32",
                    "--no-train-eval"]
DR_TRAIN_ARGS = TRAIN_ARGS + ["--dr-variants", "4"]
# the kernel builds: the 24-body humanoid, masterfoot, SMPL-H, SMPL-X
BODIES = (24, 48, 52, 55)
# remove_toe's 22-body tree (phase remove_toe), and the largest tree of the
# small-tree layout, built and sized only (no tree of 32 bodies exists)
TOE_BODIES, COMPILE_ONLY_BODIES = 22, (32,)
BIG = (("smplh", 52), ("masterfoot", 48))
SMPLX_BODIES = 55
# phase rollout_smplx: the big trees' rollout size (SMPLH_TRAIN_ARGS)
SMPLX_ROLLOUT = (512, 32)
# phase k2b: the trees of its draws, and the launch counters' tree names
K2B_TREES = (("smpl", 24), ("smplh", 52), ("smplx", SMPLX_BODIES))
# phase kernel_bench: the rows of uhc_tpu_torch.cli.kernel_bench
KERNEL_BENCH_ROWS = ("SPLIT=1,PCG=2", "SPLIT=1,PCG=2,BF16=1",
                     "SPLIT=1,PCG=2,MODEL=smplh",
                     "SPLIT=1,PCG=2,BF16=1,MODEL=smplh",
                     "SPLIT=0,PCG=2,BF16=1", "LANE=1,PCGPD=1,PCG=2")
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
_T0 = time.perf_counter()       # phase lines print the seconds since here
TRAIN_RATES = {}     # phase -> per-epoch rollout rates and PPO times


class Deadline(Exception):
    pass


def _on_alarm(signum, frame):
    raise Deadline(f"deadline of {DEADLINE_S} s passed")


def phase(name: str, detail: str = "") -> None:
    _phase[0] = name
    print(f"phase {name} {detail} [{time.perf_counter() - _T0:.1f} s]"
          .replace("  [", " ["), flush=True)


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
                                   ("k2big_tail", "tail"))},
            # K2 on SMPL-X, and K1's build at 55 bodies (a check only)
            "k2_head_smplx": ("head", SMPLX_BODIES, False),
            "k2_tail_smplx": ("tail", SMPLX_BODIES, False),
            "k1_smplx": ("step", SMPLX_BODIES, False),
            # remove_toe's 22 bodies: K1, K1f, K2's head and tail, K1e
            "k1_22": ("step", TOE_BODIES, False),
            "k1f_22": ("k1f", TOE_BODIES, False),
            "k2_head_22": ("head", TOE_BODIES, False),
            "k2_tail_22": ("tail", TOE_BODIES, False),
            "k1e_22": ("step", TOE_BODIES, True),
            # K2b: head, tail and the one-launch form (split=False)
            **{f"{name}_{tree}": (entry, nb, False) for tree, nb in K2B_TREES
               for name, entry in (("k2b_head", "head_bf16"),
                                   ("k2b_tail", "tail_bf16"),
                                   ("k1_bf16", "step_bf16"))}}


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


def gate(name, out, plain32, plain64, moved=None) -> tuple:
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
    printed; more than one in eight fails.

    With `moved` (env -> the float64 and float32 plain steps from its
    state moved by 1-2 float32 ulps, as `gate_big` takes it), an edge env
    where the kernel lands on neither side passes only by a witness: one
    of those moved steps lands within the bounds of the kernel's answer
    (printed as `edge_witnessed`, with the nearest moved step in units of
    the bounds and how many land within them). Without `moved`, or with
    no witness, such an env fails. A steep contact term does this, where
    float32 rounding of the state moves the step along a continuum
    rather than across one switch (the dynamic box's face normal,
    tests/test_torch_box_gate.py)."""
    import torch

    def per_env(a, b):
        return (a.double() - b.double()).abs().amax(1)

    k64 = [per_env(a, b) for a, b in zip(out, plain64)]
    k32 = [per_env(a, b) for a, b in zip(out, plain32)]
    p64 = [per_env(a, b) for a, b in zip(plain32, plain64)]
    edge = (p64[0] > QPOS_TOL) | (p64[1] > QVEL_TOL)
    off32 = (k32[0] > QPOS_TOL) | (k32[1] > QVEL_TOL)
    off64 = (k64[0] > QPOS_TOL) | (k64[1] > QVEL_TOL)
    # edge envs where the kernel lands with float64 and not with float32
    held64 = edge & off32 & ~off64
    witnessed, rows, fails = torch.zeros_like(edge), [], []
    neither = edge & off32 & off64
    for e in torch.nonzero(neither if moved is not None
                           else torch.zeros_like(edge))[:, 0].tolist():
        nearest, within = witness(out, e, moved)
        rows.append({"env": e, "kernel_vs_plain64": [k64[0][e].item(),
                                                     k64[1][e].item()],
                     "kernel_vs_plain32": [k32[0][e].item(),
                                           k32[1][e].item()],
                     "plain32_vs_plain64": [p64[0][e].item(),
                                            p64[1][e].item()],
                     "nearest_moved_step": nearest,
                     "moved_steps_within_bounds": within})
        witnessed[e] = within > 0
        if not within:
            fails.append(f"{name}: edge env {e} lands on neither side "
                         f"({rows[-1]}), and no plain step from its state "
                         f"moved by {ULP_MOVES} float32 ulps lands there")

    def mx(x, mask):
        return x[mask].max().item() if bool(mask.any()) else 0.0

    every = torch.ones_like(edge)
    held = ~(held64 | witnessed)
    errs = {"kernel_vs_plain64": [mx(k64[0], ~edge), mx(k64[1], ~edge)],
            "kernel_vs_plain32": [mx(k32[0], held), mx(k32[1], held)],
            "plain32_vs_plain64": [mx(p64[0], every), mx(p64[1], every)],
            "edge_envs": int(edge.sum()),
            "edge_kernel_vs_plain64": [mx(k64[0], edge), mx(k64[1], edge)],
            "edge_plain32_vs_plain64": [mx(p64[0], edge), mx(p64[1], edge)],
            "edge_held_to_plain64": [
                {"env": e, "kernel_vs_plain64": [k64[0][e].item(),
                                                 k64[1][e].item()],
                 "kernel_vs_plain32": [k32[0][e].item(), k32[1][e].item()]}
                for e in torch.nonzero(held64)[:, 0].tolist()]}
    if moved is not None:
        errs["edge_witnessed"] = rows
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


def witness(out, e, moved) -> tuple:
    """How near the plain steps `moved(e)` (from env e's state moved by
    1-2 float32 ulps) come to the kernel's answer `out` on env e -> (the
    nearest, in units of the bounds; how many land within them)."""
    import torch

    def per_env(a, b):
        return (a.double() - b.double()).abs().amax(1)

    ratio = torch.cat([torch.maximum(per_env(q, out[0][e:e + 1]) / QPOS_TOL,
                                     per_env(v, out[1][e:e + 1]) / QVEL_TOL)
                       for q, v in moved(e)])
    return ratio.min().item(), int((ratio <= 1).sum())


def on_tree(env_cfg, family: str):
    """`env_cfg` on a big tree: "smplh" or "masterfoot"."""
    import dataclasses

    return dataclasses.replace(env_cfg, robot_model="smplh"
                               if family == "smplh" else "smpl",
                               masterfoot=family == "masterfoot")


def plain_pair(topo, env_cfg, model, ins, pcg_iters, refresh_at=None,
               precond_bf16=False):
    """The float32 and float64 plain versions of one control step of `ins`
    -> (plain32, plain64)."""
    from uhc_tpu_torch.physics import control_step as CS

    return (CS.control_step_reference(topo, env_cfg, model, *ins, 1.0,
                                      pcg_iters, refresh_at=refresh_at,
                                      precond_bf16=precond_bf16),
            CS.control_step_reference(
                topo, env_cfg, double_model(model),
                *[t.double() for t in ins], 1.0, pcg_iters,
                refresh_at=refresh_at, precond_bf16=precond_bf16))


def big_tree(family: str, dev, meta_pd: bool = False, smpl_data=None):
    """uhc_implicit on a big tree built from the stand-in: "smplh" (52
    bodies; its bone offsets from `smpl_data`, a 52-joint model file,
    where given) or "masterfoot" (48) -> (topo, env cfg, model, expert
    library of the gait clips on that tree)."""
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
    topo, model_np, conv, _, _ = robot_family(topo24, model24, env,
                                              smpl_data)
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


def k1d_draws(dev, B=B_CHECK):
    """The draws of phase k1d_vs_plain (B_CHECK envs each; phase k2_big
    draws its heads' B_HEAD envs so), one case after another: (family,
    mode, topo, env cfg, model, (qpos, qvel, actions, target_base)) for
    SMPL-H and masterfoot, plain PD and meta-PD, B envs each, made on the
    host from one seeded generator and moved to `dev`."""
    import torch

    from uhc_tpu_torch.physics import solver

    gen = torch.Generator().manual_seed(13)
    for fam, _ in BIG:
        for mode in ("plain_pd", "meta_pd"):
            btopo, benv, bmodel, blib = big_tree(fam, dev,
                                                 mode == "meta_pd")
            qpos, qvel, tb = draw_big_states(blib, btopo.nv, B, gen, dev)
            n_act = sum(solver.action_dims(btopo, benv))
            act = (0.02 * torch.randn((B, n_act), generator=gen)).to(dev)
            yield fam, mode, btopo, benv, bmodel, (qpos, qvel, act, tb)


# a missed env's state moved by 1 and by 2 float32 ulps (relative 2⁻²³ per
# ulp, every entry of qpos and qvel, seeded signs), MOVES copies each
ULP_MOVES, MOVES = (1, 2), 32
# gate_bf16 moves this many missed envs' states in one plain step
MOVED_CHUNK = 8


def ulp_moved(ins, env, dtype, moved=(0, 1), seed=0) -> list:
    """Copies of env `env` of `ins`, or of each env of a list one after
    another, in `dtype`: len(ULP_MOVES) * MOVES copies of each env, the
    inputs at indices `moved` moved by ULP_MOVES float32 ulps (random
    signs per entry, from `seed`), the others repeated."""
    import torch

    envs = [env] if isinstance(env, int) else list(env)
    n = len(ULP_MOVES) * MOVES
    gen = torch.Generator().manual_seed(seed)
    rel = torch.tensor([u * 2.0 ** -23 for u in ULP_MOVES
                        for _ in range(MOVES)], dtype=dtype)[:, None]
    rel = rel.repeat(len(envs), 1)
    out = []
    for k, x in enumerate(ins):
        c = x[envs].to(dtype).repeat_interleave(n, 0).contiguous()
        if k in moved:
            sign = 2 * torch.randint(0, 2, (len(rel), x.shape[1]),
                                     generator=gen) - 1
            c = (c * (1 + (rel * sign).to(c))).contiguous()
        out.append(c)
    return out


def moved_steps(topo, env_cfg, model, ins, env, dtype, seed=0, trace=None,
                pcg_iters=(2, 2), refresh_at=None, precond_bf16=False,
                inverses=None, stop=None):
    """The plain step in `dtype` at `pcg_iters` (the big trees' (2, 2) by
    default; with K1g's `refresh_at`, with K2b's `precond_bf16` and the
    (B, 2, nv, nv) `inverses` the step takes in place of substep 0's; its
    first `stop` substeps alone where given, the head's 1) of env `env`
    of `ins` (qpos, qvel, actions, target_base), or of each env of a list
    one after another, from copies of its state moved by ULP_MOVES float32
    ulps (`ulp_moved`) -> (qpos', qvel') of the len(ULP_MOVES) * MOVES
    copies of each env; `trace` receives each substep's ground-contact
    sets."""
    import torch

    from uhc_tpu_torch.physics import solver

    m = model if dtype == torch.float32 else double_model(model)
    given = None if inverses is None else [
        x.contiguous() for x in ulp_moved(
            (inverses[:, 0], inverses[:, 1]), env, dtype, moved=())]
    return solver.substeps(
        topo, env_cfg, m, *ulp_moved(ins, env, dtype, seed=seed), 1.0,
        pcg_iters, 0, env_cfg.frame_skip if stop is None else stop,
        inverses=given, trace=trace, refresh_at=refresh_at,
        precond_bf16=precond_bf16)[:2]


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
      does, plus half that and one (the count rule), and on at most one env
      in eight.
    Every missed env is printed: the kernel's and the float32 plain
    version's distances from the float64 one, the rule it passed by, and
    for a witness the nearest moved step (in units of the bounds) and how
    many moved steps land within the bounds. The count rule compares
    rates: where float32 misses on a few envs in a thousand (the
    masterfoot head after one substep), it needs a draw of thousands of
    envs (phase k2_big's B_HEAD).
    """
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
            (row["nearest_moved_step"],
             row["moved_steps_within_bounds"]) = witness(out, e, moved)
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


# the launching entry points of a control-step library
ENTRIES = ("uhc_control_step", "uhc_control_step_f", "uhc_control_step_head",
           "uhc_control_step_tail", "uhc_control_step_bf16",
           "uhc_control_step_head_bf16", "uhc_control_step_tail_bf16")


# the int table's config entries after its J6 / G layout (control_step.cu
# I_SELFCOL .. I_REFRESH)
ITAB_CONFIG = 8


class OlderEntries:
    """A library built from a control_step.cu older than J6 and G stored
    by subtree, called as this checkout's wrappers call theirs: its entry
    points take no J6 / G floats before the stream (each is declared anew
    without them, beside the declaration `build` gave the library)."""

    def __init__(self, lib):
        self._lib = lib
        self._entries = {}

    def __getattr__(self, name):
        if name not in ENTRIES:
            return getattr(self._lib, name)
        if name not in self._entries:
            fn = self._lib[name]        # a function object of its own
            argtypes = getattr(self._lib, name).argtypes
            fn.argtypes = argtypes[:-2] + argtypes[-1:]
            fn.restype = ctypes.c_int
            self._entries[name] = (
                lambda *args, fn=fn: fn(*args[:-2], args[-1]))
        return self._entries[name]


def on_library(step, lib):
    """`step` (a ControlStep or ControlStepSplit) launching the kernels of
    the CUDA library `lib` (another build) instead of its tree's. A build
    of an older source, whose int table lacks the J6 / G layout before its
    config entries, gets the table without it and the calls of
    `OlderEntries`."""
    import numpy as np

    from uhc_tpu_torch.csrc import build

    n = build.layout(lib)["itab"]
    if n < step.itab.size:
        it = step.itab
        step.itab = np.concatenate([it[:n - ITAB_CONFIG],
                                    it[-ITAB_CONFIG:]])
        lib = OlderEntries(lib)
    step.library = lambda: lib
    return step


def against_parent(calls: dict, reps: int) -> dict:
    """`calls`: name -> (this checkout's call, the --parent build's call on
    the same inputs), each returning a tuple of tensors -> {"turns":
    `in_turns`, "equal_outputs": {name: bit for bit}}; raises where an
    output is not equal."""
    same = {k: outputs_equal(this(), parent())
            for k, (this, parent) in calls.items()}
    if not all(same.values()):
        raise RuntimeError(f"--parent: outputs not equal bit for bit: "
                           f"{same}")
    return {"turns": in_turns(calls, reps), "equal_outputs": same}


def outputs_equal(a, b) -> bool:
    """Whether two kernels' output tuples are equal bit for bit."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def in_turns(pairs: dict, reps: int) -> dict:
    """Each entry of `pairs`, name -> (this checkout's call, the --parent
    build's call on the same inputs), timed by cuda_ms over `reps` calls
    in turns parent, this, this, parent -> {name: {"ms", "parent_ms"
    (means of two turns), "over_parent", "turns_parent_this_this_parent"}}
    ."""
    out = {}
    for name, (this, parent) in pairs.items():
        turns = [cuda_ms(fn, reps) for fn in (parent, this, this, parent)]
        ms, parent_ms = 0.5 * (turns[1] + turns[2]), 0.5 * (turns[0]
                                                          + turns[3])
        out[name] = {"ms": ms, "parent_ms": parent_ms,
                     "over_parent": ms / parent_ms,
                     "turns_parent_this_this_parent": turns}
    return out


def time_split(k1d_ms, k1d_11_ms, head_ms, tail_ms, substeps) -> dict:
    """A big-tree control step's time split three ways: the exact inverse
    pair as K2's head less one of the tail's substeps-1 substeps; the PCG
    as three times K1d at (2, 2) less K1d at (1, 1) on the same states
    (that difference is one iteration of each solve a substep, 30 pairs
    of matrix-vector products, A and X; (2, 2) runs 90: warm start,
    residual and two iterations); the assembly (phases A-I) as the
    rest."""
    inverse = head_ms - tail_ms / (substeps - 1)
    pcg_30 = k1d_ms - k1d_11_ms
    return {"inverse_pair_ms": inverse, "pcg_30_pairs_ms": pcg_30,
            "pcg_ms": 3 * pcg_30,
            "assembly_ms": k1d_ms - inverse - 3 * pcg_30}


def big_rows(fam, src, k2_src, train_counts, k1d_err, head_err,
             timing) -> list:
    """The kernels-line rows of K1d and of K2's head and tail on one big
    tree: launches from its training phases (SMPL-H's smplh_data too),
    times at B_BIG_TIME[0]."""
    t = timing[f"B{B_BIG_TIME[0]}"]
    split = train_counts[f"train_{fam}_split"]
    return [
        {"name": f"control_step_big_{fam}", "route": "cuda", "source": src,
         "replaces": "uhc_tpu/physics/pallas_lane.py:83",
         # SMPL-H's training on the anthropometric and on the data-built
         # model
         "launches": sum(train_counts[run][f"k1d_{fam}"]
                         for run in (f"train_{fam}", f"{fam}_data")
                         if run in train_counts),
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
    SCHED_QPOS_TOL / SCHED_QVEL_TOL of the float64 plain PCG-8 step where
    its schedule is (`pcg8_gate`), and apart from the same step without
    the refresh by more than QPOS_TOL in qpos -> (errors, failures, the
    kernel's output)."""
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
    pcg8 = pcg8_gate(name, topo, env_cfg, model, ins, out, plain64, e, f)
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


def pcg8_gate(name, topo, env_cfg, model, ins, out, plain64, e, f):
    """Hold a kernel's (qpos, qvel) within SCHED_QPOS_TOL / SCHED_QVEL_TOL
    of the float64 plain PCG-8 step, wherever the float64 plain version of
    its own schedule (`plain64`) is within them; add the readings to the
    errors `e` and the failures to `f`.

    The PCG-8 bounds are the schedule's, not the kernel's: an env where
    the float64 plain version of the same schedule misses them itself (a
    state its PCG iterations do not solve to them) is held to its plain
    versions alone and printed with both distances; more than one such
    env in eight fails. Returns the float64 PCG-8 step."""
    import torch

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
    return pcg8


def smplx_pose(pose_aa):
    """A 72-dof SMPL clip as a 165-dof SMPL-X pose: body dofs 0-65 from
    the clip, jaw and eyes (66-74) at 0.1 (tests/test_smplh.py:137),
    fingers zero."""
    import numpy as np

    pose_aa = np.asarray(pose_aa, np.float32)
    out = np.zeros((len(pose_aa), 165), np.float32)
    out[:, :66] = pose_aa[:, :66]
    out[:, 66:75] = 0.1
    return out


def smplx_tree(dev, meta_pd: bool = False, data=None):
    """uhc_implicit on the 55-body SMPL-X tree built from the stand-in
    (`smplx_model`'s anthropometric defaults, or every bone offset from
    `data`, a 55-joint model file, through `smplx_model_from_data`) ->
    (topo, env cfg, model, expert library of the six gait clips as
    165-dof poses)."""
    import dataclasses

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid
    from uhc_tpu_torch.smpl.lbs import load_smplh_data
    from uhc_tpu_torch.smpl.smplh import (smplx_model,
                                          smplx_model_from_data,
                                          smplx_topology)

    topo24, model24 = load_fixture_humanoid()
    topo = smplx_topology()
    model = model_from_numpy(
        smplx_model(topo24, model24) if data is None else
        smplx_model_from_data(topo24, model24, load_smplh_data(data)), dev)
    seqs = {k: {"pose_aa": smplx_pose(v["pose_aa"]), "trans": v["trans"]}
            for k, v in load_motion_file(
                "sample_data/gait_clips.pkl").items()}
    lib, _ = build_expert_library(topo, model, seqs)
    env = dataclasses.replace(Config.uhc_implicit().env, meta_pd=meta_pd)
    return topo, env, model, lib


def smplx_draws(dev, data=None, seed=20):
    """The draws of phase k2_smplx (smplx_data with `data`, the tree of
    that model file): (mode, topo, env cfg, model, (qpos, qvel, actions,
    target_base)) in plain PD and meta-PD, B_CHECK envs each from the
    SMPL-X library, made on the host from one seeded generator and moved
    to `dev`."""
    import torch

    from uhc_tpu_torch.physics import solver

    gen = torch.Generator().manual_seed(seed)
    for mode in ("plain_pd", "meta_pd"):
        topo, env, model, lib = smplx_tree(dev, mode == "meta_pd", data)
        qpos, qvel, tb = draw_big_states(lib, topo.nv, B_CHECK, gen, dev)
        n_act = sum(solver.action_dims(topo, env))
        act = (0.02 * torch.randn((B_CHECK, n_act), generator=gen)).to(dev)
        yield mode, topo, env, model, (qpos, qvel, act, tb)


def x_check(name, X, X32, X64, fails, precond_bf16=False) -> dict:
    """A head's Xp/Xf `X` against the float64 plain exact inverses `X64`:
    max abs, and max relative to max|X| of each matrix, held to
    X_REL_TOL, or where the float32 plain inverses `X32` themselves miss
    it, to twice their own error on the same draws (both factor in
    float32, rounding about cond(A)·2⁻²⁴; on SMPL-X, whose face
    micro-bodies make A worse conditioned, the float32 plain inverses read
    1.5e-4 and the host build of the kernel's unblocked factorization up
    to 1.29 times that, on 64 CPU draws). Under `precond_bf16` each entry
    may differ from the exact inverse by its own rounding to bfloat16 too
    (half an ulp, at most 2⁻⁸ of the entry), which the relative reading
    leaves out; that it is the nearest bfloat16 to K2's own float32 entry
    is checked bit for bit apart (`k2b_check`). Failures go to `fails`."""
    scale = X64.abs().amax((2, 3), keepdim=True)
    rounding = 2.0 ** -8 * X64.abs() if precond_bf16 else 0.0
    diff = (X.double() - X64).abs()
    rel = ((diff - rounding).clamp(min=0) / scale).max().item()
    rel32 = ((X32.double() - X64).abs() / scale).max().item()
    tol = max(X_REL_TOL, 2 * rel32)
    if not rel <= tol:
        fails.append(f"{name}: head Xp/Xf relative error {rel} (bound "
                     f"{tol}; the float32 plain inverses {rel32})")
    return {"head_X_vs_plain64": [diff.max().item(), rel],
            "plain32_X_vs_plain64": rel32, "x_rel_tol": tol}


def head_references(topo, env_cfg, model, ins) -> tuple:
    """K2's plain head (substep 0 at PCG-2, exact inverses) on `ins` in
    float32 and in float64 -> ((qpos, qvel, X) float32, the same float64)."""
    from uhc_tpu_torch.physics import control_step_split as K2

    return (K2.head_reference(topo, env_cfg, model, *ins, 1.0, 2),
            K2.head_reference(topo, env_cfg, double_model(model),
                              *[t.double() for t in ins], 1.0, 2))


def k2_smplx_check(draws) -> tuple:
    """K2 on SMPL-X (head + tail of the -DNB=55 build at PCG-2) on each
    draw: one head and one tail launch, finite, bit-equal to the 55-body
    K1 build at (2, 2) (a check only: no route runs K1 on 55 bodies),
    held to its float32 and float64 plain versions by `gate_big`, the
    head's state likewise against the plain head, and the head's Xp/Xf to
    the float64 plain inverses by `x_check` -> (errors, failures)."""
    import torch

    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    errs, fails = {}, []
    for mode, topo, env, model, ins in draws:
        name = f"K2 smplx {mode}"
        split = K2.ControlStepSplit(topo, env, model, 2)
        reset_counts()
        qh, vh, X = split.head(*ins, 1.0)
        out = split.tail(qh, vh, ins[2], ins[3], X, 1.0)
        if counts() != expect(1, "k2_head_smplx", "k2_tail_smplx"):
            raise RuntimeError(f"{name}: launches {counts()}")
        q1, v1 = CS.ControlStep(topo, env, model, (2, 2))(*ins, 1.0)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (*out, X)):
            raise RuntimeError(f"{name}: output not finite")
        if not (torch.equal(q1, out[0]) and torch.equal(v1, out[1])):
            raise RuntimeError(
                f"{name}: head + tail differ from K1 at (2, 2): |dqpos| "
                f"{(q1 - out[0]).abs().max().item()}, |dqvel| "
                f"{(v1 - out[1]).abs().max().item()}")
        plain32, plain64 = plain_pair(topo, env, model, ins, (2, 2))

        def moved(e, topo=topo, env=env, model=model, ins=ins, stop=None):
            return [moved_steps(topo, env, model, ins, e, dt, stop=stop)
                    for dt in (torch.float64, torch.float32)]

        e, f = gate_big(name, out, plain32, plain64, moved)
        h32, h64 = head_references(topo, env, model, ins)
        eh, fh = gate_big(f"{name} head", (qh, vh), h32[:2], h64[:2],
                          lambda e_, moved=moved: moved(e_, stop=1))
        e.update(x_check(name, X, h32[2], h64[2], f), head=eh,
                 split_equals_k1=True, act_dim=split.act_dim)
        errs[mode] = e
        fails += f + fh
    return errs, fails


def gate_bf16(name, out, X, topo, env_cfg, model, ins, stop=None) -> tuple:
    """K2b's (qpos, qvel) `out` on `ins` (after its first `stop` substeps
    where given: the head's state with 1), from its own Xp/Xf `X` (the
    head's bfloat16 buffer as float32), against its float32 and float64
    plain versions given that X -> (errors, failures).

    A step with the bfloat16 preconditioner is discontinuous at every
    bfloat16 midpoint: two float32 computations of a PCG vector that
    differ in their last bits round apart on some entries, and PCG-2 moves
    the result by up to the rounding's own move (K2b against K2: up to
    4e-2 in qvel on these draws). Given the kernel's Xp/Xf only the
    vectors' roundings still split, and still the float32 plain version
    misses the float64 one (at 1e-5 / 1e-3) on 6-14 % of the envs (chip
    run, 256 draws each), more than `gate_big`'s one in eight, by as much
    as the kernel does. So each env is held on its own:
    - a sharp env (the float32 plain version within a tenth of the bounds
      of the float64 one) where the kernel is inside the bounds of the
      float64 plain version is held to the float32 plain version at the
      bounds too;
    - every env where the kernel misses the bounds of the float64 plain
      version is measured: its family is the float32 plain version and
      the plain steps (float64 and float32, given X) from its state moved
      by ULP_MOVES float32 ulps; its spread is the farthest the family
      lands from the float64 plain version, in qpos and in qvel apart.
      Where the spread is within a tenth of the bounds (no midpoint split
      within reach) a member of the family must land within the bounds of
      the kernel's (a witness, as in `gate_big`); elsewhere the kernel's
      distance from the float64 plain version must be within the spread
      plus the bounds (which a witness implies). A sharp env whose family
      spreads wider than a tenth of the bounds is held by the second rule:
      its float32 plain version only happened to round as float64 did;
    - the kernel may miss on no more envs than the float32 plain version
      does, plus half that and one.
    Every missed env is printed with its distances, spread, nearest moved
    step (in units of the bounds) and the rule it passed by."""
    import torch

    from uhc_tpu_torch.physics import solver as SV

    stop = env_cfg.frame_skip if stop is None else stop

    def plain(dtype):
        m = model if dtype == torch.float32 else double_model(model)
        Xd = X.to(dtype)
        return SV.substeps(topo, env_cfg, m, *[t.to(dtype) for t in ins],
                           1.0, (2, 2), 0, stop, inverses=(Xd[:, 0], Xd[:, 1]),
                           precond_bf16=True)[:2]

    given32, given64 = plain(torch.float32), plain(torch.float64)

    def per_env(a, b):
        return (a.double() - b.double()).abs().amax(1)

    tols = (QPOS_TOL, QVEL_TOL)
    k64 = [per_env(a, b) for a, b in zip(out, given64)]
    k32 = [per_env(a, b) for a, b in zip(out, given32)]
    p64 = [per_env(a, b) for a, b in zip(given32, given64)]
    k_out = (k64[0] > QPOS_TOL) | (k64[1] > QVEL_TOL)
    p_out = (p64[0] > QPOS_TOL) | (p64[1] > QVEL_TOL)
    sharp = (p64[0] <= QPOS_TOL / 10) & (p64[1] <= QVEL_TOL / 10)
    every = torch.ones_like(k_out)

    def mx(x, mask):
        return x[mask].max().item() if bool(mask.any()) else 0.0

    n = len(ULP_MOVES) * MOVES
    missed, fails = [], []
    envs = torch.nonzero(k_out)[:, 0].tolist()
    for c in range(0, len(envs), MOVED_CHUNK):
        chunk = envs[c:c + MOVED_CHUNK]
        steps = [moved_steps(topo, env_cfg, model, ins, chunk, dt,
                             precond_bf16=True, inverses=X, stop=stop)
                 for dt in (torch.float64, torch.float32)]
        for j, e in enumerate(chunk):
            moved = [torch.cat([s[p][j * n:(j + 1) * n] for s in steps])
                     for p in (0, 1)]
            ratio = torch.maximum(*[per_env(moved[p], out[p][e:e + 1])
                                    / tols[p] for p in (0, 1)])
            spread = [max(p64[p][e].item(), per_env(
                moved[p], given64[p][e:e + 1]).max().item()) for p in (0, 1)]
            row = {"env": e, "kernel_vs_plain64": [k64[0][e].item(),
                                                   k64[1][e].item()],
                   "plain32_vs_plain64": [p64[0][e].item(),
                                          p64[1][e].item()],
                   "sharp": bool(sharp[e]), "spread": spread,
                   "nearest_moved_step": ratio.min().item(),
                   "moved_steps_within_bounds": int((ratio <= 1).sum())}
            smooth = all(spread[p] <= tols[p] / 10 for p in (0, 1))
            if row["moved_steps_within_bounds"]:
                row["passed_by"] = "witness"
            elif not smooth and all(row["kernel_vs_plain64"][p]
                                    <= spread[p] + tols[p] for p in (0, 1)):
                row["passed_by"] = "spread"
            else:
                row["passed_by"] = None
                fails.append(f"{name}: env {e} misses the float64 plain "
                             f"version by {row['kernel_vs_plain64']} (the "
                             f"float32 plain version by "
                             f"{row['plain32_vs_plain64']}), no plain step "
                             f"from its state moved by {ULP_MOVES} float32 "
                             f"ulps lands within the bounds of it (nearest "
                             f"{row['nearest_moved_step']} × the bounds), "
                             f"and its family's spread {spread} "
                             + ("is within a tenth of the bounds" if smooth
                                else "plus the bounds is less"))
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
            "passed_by_spread": sum(r["passed_by"] == "spread"
                                    for r in missed),
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
    return errs, fails


def k2b_check(tree, topo, env_cfg, model, ins) -> tuple:
    """K2b (head + tail with the bfloat16 preconditioner at PCG-2) on the
    draws `ins` of `tree` ("smpl", "smplh" or "smplx") -> (errors,
    failures): one head and one tail launch, a torch.bfloat16 Xp/Xf
    buffer, finite, bit-equal to K1 with the flag at (2, 2)
    (split=False); the head's Xp/Xf bit-equal to K2's head's float32
    Xp/Xf on the same states rounded to the nearest bfloat16, ties to even
    (torch's .to(bfloat16)), and held to the float64 plain exact inverses
    by `x_check`; the step and the head's state held to their plain
    versions given the head's Xp/Xf by `gate_bf16`, and the step to the
    float64 plain PCG-8 step by `pcg8_gate`. The plain versions that round
    their own Xp/Xf are printed beside them (`own_rounding`), and the
    same step without the flag (K2)."""
    import torch

    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    name = f"K2b {tree} {'meta_pd' if env_cfg.meta_pd else 'plain_pd'}"
    split = K2.ControlStepSplit(topo, env_cfg, model, 2, precond_bf16=True)
    reset_counts()
    qh, vh, X = split.head(*ins, 1.0)
    out = split.tail(qh, vh, ins[2], ins[3], X, 1.0)
    if counts() != expect(1, f"k2b_head_{tree}", f"k2b_tail_{tree}") \
            or X.dtype != torch.bfloat16:
        raise RuntimeError(f"{name}: launches {counts()}, Xp/Xf {X.dtype}")
    q1, v1 = CS.ControlStep(topo, env_cfg, model, (2, 2),
                            precond_bf16=True)(*ins, 1.0)
    q2, v2 = CS.ControlStep(topo, env_cfg, model, (2, 2))(*ins, 1.0)
    X2 = K2.ControlStepSplit(topo, env_cfg, model, 2).head(*ins, 1.0)[2]
    torch.cuda.synchronize()
    Xf = X.float()
    if not all(bool(torch.isfinite(t).all()) for t in (*out, Xf)):
        raise RuntimeError(f"{name}: output not finite")
    if not (torch.equal(q1, out[0]) and torch.equal(v1, out[1])):
        raise RuntimeError(
            f"{name}: head + tail differ from K1 with the flag at (2, 2): "
            f"|dqpos| {(q1 - out[0]).abs().max().item()}, |dqvel| "
            f"{(v1 - out[1]).abs().max().item()}")
    rne = X2.to(torch.bfloat16)
    if not torch.equal(X.view(torch.int16), rne.view(torch.int16)):
        n = int((X.view(torch.int16) != rne.view(torch.int16)).sum())
        raise RuntimeError(f"{name}: {n} of {X.numel()} head Xp/Xf entries "
                           f"are not K2's rounded to the nearest bfloat16")
    e, f = gate_bf16(name, out, Xf, topo, env_cfg, model, ins)
    eh, fh = gate_bf16(f"{name} head", (qh, vh), Xf, topo, env_cfg, model,
                       ins, stop=1)
    own32, own64 = plain_pair(topo, env_cfg, model, ins, (2, 2),
                              precond_bf16=True)

    def per_env(a, b):
        return [(x.double() - y.double()).abs().amax(1) for x, y in zip(a, b)]

    def misses(d):
        return int(((d[0] > QPOS_TOL) | (d[1] > QVEL_TOL)).sum())

    k64, p64 = per_env(out, own64), per_env(own32, own64)
    e["own_rounding"] = {
        "kernel_vs_plain64": [x.max().item() for x in k64],
        "kernel_vs_plain32": [x.max().item() for x in per_env(out, own32)],
        "plain32_vs_plain64": [x.max().item() for x in p64],
        "kernel_misses": misses(k64), "plain32_misses": misses(p64)}
    pcg8_gate(name, topo, env_cfg, model, ins, out, own64, e, f)
    h32, h64 = head_references(topo, env_cfg, model, ins)
    e.update(x_check(name, Xf, h32[2], h64[2], f, True), head=eh,
             x_equals_k2_rounded=True, split_equals_k1_bf16=True,
             bf16_moves=[(out[0] - q2).abs().max().item(),
                         (out[1] - v2).abs().max().item()])
    return e, f + fh


def rollout_smplx(dev, data=None) -> dict:
    """The env's main path on SMPL-X (the tree of the model file `data`
    where given): `make_env_step_batched(smplx_topology(), cfg,
    fused_model=model)` through learn/rollout.py, SMPLX_ROLLOUT envs
    × steps with a seeded MCP policy at SMPL-X's obs and action widths and
    unit diff weights (the JAX package has none for SMPL-X): one K2-55
    head and tail launch per step and no call of the plain chain, finite
    rewards and observations -> its numbers."""
    import torch

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.rollout import init_env_states, make_rollout_fn
    from uhc_tpu_torch.physics import solver
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit

    topo, env, model, lib = smplx_tree(dev, data=data)
    B, T = SMPLX_ROLLOUT
    cfg = Config.uhc_implicit()
    obs_dim, act_dim = H.obs_dim(topo, env), sum(H.action_dims(topo, env))
    kernel = H.make_env_step_batched(topo, env, fused_model=model).kernel
    if type(kernel) is not ControlStepSplit or kernel.pcg_iters != (2, 2):
        raise RuntimeError(f"SMPL-X routes to {kernel}")
    policy = nets.make_policy(cfg, obs_dim, act_dim,
                              torch.Generator().manual_seed(21), dev)
    rollout = make_rollout_fn(topo, env, policy, T, fused_model=model)
    aux = {"neutral_qpos": lib["qpos"][0, 0],
           "neutral_qvel": torch.zeros(topo.nv, device=dev),
           "jpos_diffw": torch.ones(topo.nbody, device=dev),
           "body_diffw": torch.ones(topo.nbody - 1, device=dev)}
    gen = torch.Generator(device=dev).manual_seed(21)
    states = init_env_states(topo, env, model, lib, aux, gen, B)
    plain_calls = []
    plain = solver.do_simulation

    def counted(*a, **k):
        plain_calls.append(1)
        return plain(*a, **k)

    reset_counts()
    solver.do_simulation = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, traj, last = rollout(
            model, lib, aux, torch.full((act_dim,), cfg.log_std, device=dev),
            RN.init(obs_dim, dev), states, gen, 1.0, 1.0,
            torch.zeros(lib["len"].shape[0], device=dev))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        solver.do_simulation = plain
    got = counts()
    if got != expect(T, "k2_head_smplx", "k2_tail_smplx") or plain_calls:
        raise RuntimeError(f"rollout_smplx: launches {got}, plain chain "
                           f"calls {len(plain_calls)}")
    if not all(bool(torch.isfinite(t).all()) for t in (
            traj.rewards, traj.states, last)):
        raise RuntimeError("rollout_smplx: rewards or observations not "
                           "finite")
    return {"launches": got, "num_envs": B, "horizon": T,
            "obs_dim": obs_dim, "action_dim": act_dim,
            "env_steps_per_s": B * T / secs, "seconds": secs,
            "reward_mean": traj.rewards.mean().item(),
            "episodes_done": int(traj.dones.sum()),
            "plain_chain_calls": 0}


def smplx_rows(src, k2_src, rollouts, k2x_errs, smplx_time) -> list:
    """The kernels-line rows of K2's head and tail on SMPL-X: launches
    from the rollouts of phases rollout_smplx and smplx_data, times at
    B_BIG_TIME[0]."""
    t = smplx_time[f"B{B_BIG_TIME[0]}"]
    return [
        {"name": f"control_step_{part}_smplx", "route": "cuda",
         "source": src, "replaces": k2_src,
         "launches": sum(r["launches"][f"k2_{part}_smplx"]
                         for r in rollouts),
         "max_abs_err": max(v for e in k2x_errs.values()
                            for v in (e["head"] if part == "head" else e)[
                                "kernel_vs_plain64"]),
         "ms": t[f"{part}_ms"], "plain_ms": t[f"plain_{part}_ms"],
         "bound_ms": t["bound"][part]["bound_ms"],
         "bound_by": t["bound"][part]["bound_by"], "library_ms": None}
        for part in ("head", "tail")]


def k2b_rows(src, k2_src, bench_counts, k2b_errs, t) -> list:
    """The kernels-line rows of K2b on the 24-body tree: head, tail and
    the one-launch form (split=False); launches from phase kernel_bench,
    times `t` from phase time (B_TIME), errors over every tree of phase
    k2b (head + tail equal the one-launch form bit for bit there)."""
    tail_err = max(v for e in k2b_errs.values()
                   for v in e["kernel_vs_plain64"])
    head_err = max(v for e in k2b_errs.values()
                   for v in e["head"]["kernel_vs_plain64"])
    rows = [(f"control_step_{part}_bf16", bench_counts[f"k2b_{part}_smpl"],
             err, t[f"{part}_ms"], t[f"plain_{part}_ms"],
             t["bound"][part])
            for part, err in (("head", head_err), ("tail", tail_err))]
    rows.append(("control_step_bf16", bench_counts["k1_bf16_smpl"],
                 tail_err, t["k1_bf16_ms"], t["k1_bf16_plain_ms"],
                 t["k1_bf16_bound"]))
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": k2_src, "launches": n, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
             "bound_by": b["bound_by"], "library_ms": None}
            for name, n, err, ms, plain_ms, b in rows]


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


# the ball phase: its torque step timed at the training batch; its eval
# cut to the clips' first frames (the eager torque route takes ~0.33 s a
# control step at 6 envs on the card, 80 s for the full 239); one training
# epoch of BALL_HORIZON steps and 15 eval frames (2 epochs of 48 and 120
# frames before the tools phase came, 48 and 30 before the data_parallel
# phase) keep the whole run inside DEADLINE_S on a slow host (PERF.md §5:
# host-bound phases up to 25 % slower than on another)
B_BALL_TIME, BALL_EVAL_FRAMES, BALL_EPOCHS, BALL_HORIZON = 1024, 15, 1, 24


def model_data_file(directory, nj: int) -> str:
    """A seeded nj-joint model file (`synthetic_smpl_data(nj=nj)`, whose
    random regressor gives a skeleton of centimetre bones) in the layout
    of the SMPL-H / SMPL-X releases, written to `directory`."""
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data

    return save_model_file(synthetic_smpl_data(nj=nj),
                           os.path.join(directory, f"model{nj}.npz"))


def save_model_file(sd, path: str) -> str:
    """SMPLData -> an npz in the layout of the SMPL releases."""
    import numpy as np

    np.savez(path, v_template=sd.v_template.numpy(),
             shapedirs=sd.shapedirs.numpy(),
             J_regressor=sd.j_regressor.numpy(), weights=sd.weights.numpy())
    return path


def smplh_data_phase(dev, directory) -> tuple:
    """SMPL-H from model data: cli/train --robot-model smplh --smpl-data
    on a seeded 52-joint file, 1 epoch of 512 × 32 through K1d on the
    model built from it, then K1d on that model (plain PD, (2, 2),
    B_CHECK draws of its clip frames) against its float32 and float64
    plain versions by `gate_big` -> (the training's launches, errors,
    failures)."""
    import numpy as np
    import torch

    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import solver

    path = model_data_file(directory, 52)
    got = run_train(None, 1, "smplh_data", dev, SMPLH_TRAIN_ARGS + [
        "--smpl-data", path, "--no-train-eval"], routed=("k1d_smplh",))
    topo, env, model, lib = big_tree("smplh", dev, smpl_data=path)
    anthro = big_tree("smplh", dev)[2]
    if np.allclose(model.body_pos.cpu().numpy(),
                   anthro.body_pos.cpu().numpy()):
        raise RuntimeError("smplh_data: the model has the anthropometric "
                           "offsets, not the data's")
    gen = torch.Generator().manual_seed(23)
    qpos, qvel, tb = draw_big_states(lib, topo.nv, B_CHECK, gen, dev)
    act = (0.02 * torch.randn((B_CHECK, sum(solver.action_dims(topo, env))),
                              generator=gen)).to(dev)
    ins = (qpos, qvel, act, tb)
    reset_counts()
    out = CS.ControlStep(topo, env, model, (2, 2))(*ins, 1.0)
    torch.cuda.synchronize()
    if counts() != expect(1, "k1d_smplh") or not all(
            bool(torch.isfinite(t).all()) for t in out):
        raise RuntimeError(f"K1d smplh_data: launches {counts()} or output "
                           "not finite")
    plain32, plain64 = plain_pair(topo, env, model, ins, (2, 2))
    errs, fails = gate_big(
        "K1d smplh_data", out, plain32, plain64,
        lambda e: [moved_steps(topo, env, model, ins, e, dt)
                   for dt in (torch.float64, torch.float32)])
    return got, errs, fails


def dense_smpl_data(topo, model, per_body: int = 16, seed: int = 25):
    """SMPL data whose bodies have hulls, for the exact-mass library:
    `synthetic_smpl_data_like`'s skeleton and bone modes, each body's
    vertices `per_body` seeded points on an ellipsoid (axes 1.5 : 1 : 0.6,
    seeded orientation) about its joint, centred on it so the regressor
    stays exact, sized so the solid ellipsoid would weigh the body's mass
    at 1000 kg/m³; beta modes move a body's points with its joint and
    scale them about it (±0.15 per unit beta)."""
    import numpy as np
    import torch

    from uhc_tpu_torch.smpl.constants import SMPL_2_MUJOCO
    from uhc_tpu_torch.smpl.lbs import SMPLData, synthetic_smpl_data_like

    like = synthetic_smpl_data_like(topo, model)
    nj = topo.nbody
    joints = (like.j_regressor @ like.v_template).numpy()    # native order
    nb = like.shapedirs.shape[-1]
    bone = like.shapedirs.numpy().reshape(nj, 4, 3, nb).mean(1)
    mass = np.zeros(nj)
    mass[SMPL_2_MUJOCO] = model.body_mass.cpu().numpy()
    rng = np.random.default_rng(seed)
    axes = np.array([1.5, 1.0, 0.6])
    v, sd = [], []
    for k in range(nj):
        r = np.cbrt(3.0 * mass[k] / (4.0 * np.pi * 1000.0 * axes.prod()))
        u = rng.standard_normal((per_body, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        rot = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        off = (u * axes * r) @ rot.T
        off -= off.mean(0)
        spread = rng.normal(scale=0.15, size=nb)
        v.append(joints[k] + off)
        sd.append(bone[k][None] + off[:, :, None] * spread[None, None])
    jr = np.kron(np.eye(nj), np.full((1, per_body), 1.0 / per_body))
    w = np.kron(np.eye(nj), np.ones((per_body, 1)))
    return SMPLData(*(torch.as_tensor(x, dtype=torch.float32) for x in (
        np.concatenate(v), np.concatenate(sd), jr, w)))


def exact_shape_phase(topo, model, dev) -> tuple:
    """The 8 shape clips, each on its own body with exact hull mass
    properties (`build_shaped_library(exact_mass=True)` over
    `dense_smpl_data`): the library's per-shape leaves include the four
    the hulls set (mass, COM, moments, principal frame), all among the
    leaves K1e gathers; K1e vs its plain versions by `gate` (B_CHECK,
    uhc_implicit_shape's meta-PD); then the closed-loop eval of the 8
    clips, full length, through K1e with a seeded policy -> (the eval's
    launches, numbers, failures)."""
    import numpy as np
    import torch

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_shaped_library,
                                            load_motion_file,
                                            neutral_from_library)
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.evaluate import make_eval_fn, summarize
    from uhc_tpu_torch.physics.control_step import PE_MODEL_LEAVES
    from uhc_tpu_torch.physics.model import model_batch_axes
    from uhc_tpu_torch.smpl.constants import default_diff_weights

    cfg = Config.uhc_implicit_shape()
    lib, keys, ml = build_shaped_library(
        topo, model, load_motion_file(SHAPE_CLIPS),
        dense_smpl_data(topo, model), cfg.env, exact_mass=True)
    leaves = {k for k, a in model_batch_axes(ml).items() if a == 0}
    hull = {"body_mass", "body_ipos", "body_inertia", "body_iquat"}
    if not hull <= leaves <= set(PE_MODEL_LEAVES):
        raise RuntimeError(f"exact_shape: library leaves {sorted(leaves)}")
    gen = torch.Generator().manual_seed(24)
    qpos, qvel, tb, seq = draw_lib_states(lib, B_CHECK, gen, dev)
    act_dim = sum(H.action_dims(topo, cfg.env))
    act = (0.02 * torch.randn((B_CHECK, act_dim), generator=gen)).to(dev)
    errs, fails = k1e_check(topo, cfg.env, ml, (qpos, qvel, act, tb, seq),
                            "exact_shape")
    obs_dim = H.obs_dim(topo, cfg.env)
    policy = nets.make_policy(cfg, obs_dim, act_dim,
                              torch.Generator().manual_seed(0), dev)
    rs = RN.RunningStats(torch.tensor(2.0, device=dev),
                         torch.zeros(obs_dim, device=dev),
                         torch.ones(obs_dim, device=dev))
    nq, nv = neutral_from_library(lib)
    jpw, bdw = default_diff_weights()
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.as_tensor(jpw, device=dev),
           "body_diffw": torch.as_tensor(bdw, device=dev)}
    steps = int(lib["len"].max()) - 1
    eval_fn = make_eval_fn(topo, cfg.env, policy, steps, fused_model=ml)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj, fail_safe, percent = eval_fn(ml, lib, aux, rs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts()
    if got != expect(steps, "k1e"):
        raise RuntimeError(f"exact_shape eval: launches {got} for {steps} "
                           "control steps")
    summary = summarize(traj, fail_safe, percent, lib, keys)["summary"]
    if not all(np.isfinite(v) for v in summary.values()):
        raise RuntimeError(f"exact_shape eval summary: {summary}")
    m = {k: getattr(ml, k).cpu().numpy() for k in sorted(hull)}
    return got, {**errs, "library_leaves": sorted(leaves),
                 "body_mass_kg": [float(m["body_mass"].sum(1).min()),
                                  float(m["body_mass"].sum(1).max())],
                 "eval_control_steps": steps,
                 "eval_ms_per_step": 1e3 * secs / steps,
                 "eval_summary": summary}, fails


def ball_phase(topo, model_np, dev) -> tuple:
    """The ball family on the card (`--cfg ball`: one quaternion per
    joint, direct torques, obs v2_quat): cli/train, BALL_EPOCHS of 1024 ×
    BALL_HORIZON, and the six-clip eval over the clips' first
    BALL_EVAL_FRAMES frames,
    neither launching a kernel (the torque route, as in the JAX package);
    its control step on the card in
    float32 against the plain step in float32 on the host and in float64
    on the card by `gate` (B_CHECK clip frames); the step timed at
    B_BALL_TIME -> (numbers, failures)."""
    import dataclasses

    import numpy as np
    import torch

    from uhc_tpu_torch.cli.eval import run_eval
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics import solver
    from uhc_tpu_torch.physics.model import model_from_numpy

    run_train(None, BALL_EPOCHS, "train_ball", dev,
              ["--cfg", "ball"] + TRAIN_ARGS
              + ["--horizon", str(BALL_HORIZON)], routed=())
    reset_counts()
    res = run_eval("sample_data/gait_clips.pkl", device=dev, seed=0,
                   cfg="ball", max_seq_len=BALL_EVAL_FRAMES)
    T = res["control_steps"]
    pred = res["traj"]["pred_qpos"]
    if counts() != expect(T) or tuple(pred.shape) != (6, T, 99) or not bool(
            torch.isfinite(pred).all()) or not all(
            np.isfinite(v) for v in res["summary"].values()):
        raise RuntimeError(f"ball eval: launches {counts()}, trajectory "
                           f"{tuple(pred.shape)}, summary {res['summary']}")
    env = Config.named("ball").env
    btopo = dataclasses.replace(topo, joint_kind="ball")
    model = model_from_numpy(model_np, dev)
    lib, _ = build_expert_library(btopo, model,
                                  load_motion_file("sample_data/gait_clips"
                                                   ".pkl"))
    gen = torch.Generator().manual_seed(26)
    draws = {}
    for B in (B_CHECK, B_BALL_TIME):
        qpos, qvel, tb = draw_big_states(lib, btopo.nv, B, gen, dev)
        act = (0.02 * torch.randn((B, btopo.ndof), generator=gen)).to(dev)
        draws[B] = (qpos, qvel, act, tb)
    ins = draws[B_CHECK]
    out = solver.do_simulation(btopo, env, model, *ins, 1.0)
    plain32 = [t.to(dev) for t in solver.do_simulation(
        btopo, env, model_from_numpy(model_np, "cpu"),
        *[t.cpu() for t in ins], 1.0)]
    plain64 = solver.do_simulation(btopo, env, double_model(model),
                                   *[t.double() for t in ins], 1.0)
    errs, fails = gate("ball torque step", out, plain32, plain64)
    big = draws[B_BALL_TIME]
    step_ms = cuda_ms(lambda: solver.do_simulation(btopo, env, model, *big,
                                                   1.0), 3)
    return {**errs, "step_ms": step_ms, "num_envs": B_BALL_TIME,
            "substeps_per_s": B_BALL_TIME * env.frame_skip / (step_ms / 1e3),
            "eval_control_steps": T, "eval_ms_per_step": res["ms_per_step"],
            "eval_summary": res["summary"],
            "train_rollout_env_steps_per_s": TRAIN_RATES["train_ball"][
                "rollout_env_steps_per_s"]}, fails


# the fit-and-eval protocol on the repository's uhc_implicit_dyn19 run:
# its iter_4000.p, the three per-sequence policies cli/fit wrote for it
# and the 19 clips it trained on
DYN19 = "results/uhc_implicit_dyn19"
DYN19_EPOCH = 4000
GAIT_EXT = "sample_data/gait_clips_ext.pkl"
FIT_KEY = "0-SYN_walk_turn_sharp"
# obs family, reward, config of phase obs_families (local_rfc_explicit
# under the explicit config, through K1f); one epoch of 1024 envs ×
# OBS_HORIZON steps each (48 before the tools phase came: the whole run's
# time on a slow host)
OBS_HORIZON = 24
OBS_FAMILIES = ((0, "world_rfc_implicit_v1_mul", "uhc_implicit"),
                (3, "world_rfc_implicit_v2", "uhc_implicit"),
                (4, "local_rfc_implicit", "uhc_implicit"),
                (5, "world_rfc_implicit_v3", "uhc_implicit"),
                (6, "local_rfc_explicit", "explicit"))


def eval_singles(dev, out_dir) -> dict:
    """Phase eval_singles: cli/eval's run_eval on the 19 clips with
    iter_4000.p and the per-sequence policies, one batched forward of the
    19 policies and one K1 launch a control step; the trajectories dumped
    to out_dir. Returns its numbers and the dump's path."""
    import numpy as np
    import torch

    from uhc_tpu_torch.cli.eval import dump_trajectories, run_eval

    reset_counts()
    res = run_eval(GAIT_EXT, device=dev, epoch=DYN19_EPOCH,
                   results_dir=DYN19, singles_dir=f"{DYN19}/_singles")
    got = counts()
    T, S = res["control_steps"], len(res["keys"])
    if got != expect(T, "k1"):
        raise RuntimeError(f"eval_singles launched {got} for {T} control "
                           f"steps")
    if len(res["fitted"]) != 3 or S != 19:
        raise RuntimeError(f"eval_singles: {len(res['fitted'])} of {S} "
                           f"clips fitted: {res['fitted']}")
    if tuple(res["traj"]["pred_qpos"].shape) != (S, T, 76) or not bool(
            torch.isfinite(res["traj"]["pred_qpos"]).all()) or not all(
            np.isfinite(v) for v in res["summary"].values()):
        raise RuntimeError(f"eval_singles: trajectory or summary not "
                           f"finite: {res['summary']}")
    dump = os.path.join(out_dir, "dump.pkl")
    n = dump_trajectories(res, dump)
    # the stacked forward of the 19 policies against one policy's on the
    # same 19 rows
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.learn import nets

    base = nets.policy_from_numpy(joblib_compat.load(
        f"{DYN19}/models/iter_{DYN19_EPOCH:04d}.p")["policy_params"],
        "relu", dev)
    x = torch.randn((S, res["rs"].mean.shape[-1]),
                    generator=torch.Generator().manual_seed(7)).to(dev)
    with torch.no_grad():
        res["policy"](x), base(x)
        policy_ms = {"stacked": cuda_ms(lambda: res["policy"](x), 20),
                     "one_policy": cuda_ms(lambda: base(x), 20)}
    return {"launches": got["k1"], "control_steps": T, "seqs": S,
            "fitted": res["fitted"], "ms_per_step": res["ms_per_step"],
            "policy_forward_ms": policy_ms, "summary": res["summary"],
            "dumped": n, "dump": dump}


def fit_phase(dev, out_dir) -> dict:
    """Phase fit: cli/fit on FIT_KEY, warm-started from a copy of
    iter_4000.p in out_dir, one epoch of 512 envs × 48 steps with the
    protocol's criterion (at most 2 before the tools phase came: the whole
    run's time on a slow host), then once more from the same copy for one
    epoch with --succ-threshold 0 --eval-every 1, so that the
    full-sequence eval over the 19 clips runs; K1 launches one per control
    step of the epochs and of each full-sequence eval; the snapshot
    reloads."""
    import shutil

    import numpy as np
    import torch

    from uhc_tpu_torch.cli import fit
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.learn import nets

    os.makedirs(os.path.join(out_dir, "models"))
    shutil.copy(f"{DYN19}/models/iter_{DYN19_EPOCH:04d}.p",
                os.path.join(out_dir, "models"))

    def run(*extra):
        reset_counts()
        res = fit.main(["--key", FIT_KEY, "--motion-file", GAIT_EXT,
                        "--epoch", str(DYN19_EPOCH), "--num-envs", "512",
                        "--horizon", "48", "--results-dir", out_dir,
                        "--device", str(dev), *extra])
        got = counts()
        agent, hist = res["agent"], res["history"]
        eval_steps = int(agent.expert_lib["len"].max()) - 1
        steps = len(hist) * agent.horizon + len(res["evals"]) * eval_steps
        if got != expect(steps, "k1") or not hist:
            raise RuntimeError(f"fit {extra}: launches {got} for "
                               f"{len(hist)} epochs and {len(res['evals'])} "
                               f"evals")
        for st in hist:
            if not all(np.all(np.isfinite(v)) for v in st.values()):
                raise RuntimeError(f"fit: stats not finite: {st}")
        return res, got["k1"], eval_steps

    res, launches, eval_steps = run("--max-epochs", "1")
    agent, hist = res["agent"], res["history"]
    d = joblib_compat.load(res["path"])
    policy = nets.policy_from_numpy(d["policy_params"], "relu", dev)
    x = torch.randn((64, agent.obs_dim),
                    generator=torch.Generator().manual_seed(6)).to(dev)
    with torch.no_grad():
        if not torch.equal(policy(x), agent.policy(x)):
            raise RuntimeError("fit: the snapshot gives another policy")
    del agent
    full, full_launches, _ = run("--max-epochs", "1", "--succ-threshold",
                                 "0", "--eval-every", "1")
    m = full["last_eval"]
    if full["evals"] != [DYN19_EPOCH] or not all(
            np.isfinite(m[k]) for k in ("succ", "mpjpe", "root_dist")):
        raise RuntimeError(f"fit: full-sequence eval {full['evals']}: {m}")
    return {"launches": launches + full_launches, "epochs": len(hist),
            "evals": res["evals"], "eval_steps": eval_steps,
            "epoch_s": [st["T_total"] for st in hist],
            "rollout_env_steps_per_s": [st["rollout_steps_per_sec"]
                                        for st in hist],
            "ppo_update_ms": [1e3 * st["T_update"] for st in hist],
            "success_rate": [st["success_rate"] for st in hist],
            "reward_mean": [st["reward_mean"] for st in hist],
            "snapshot": os.path.relpath(res["path"], out_dir),
            "full_sequence_eval": {
                "launches": full_launches, "epochs": full["evals"],
                "s": full["history"][0]["T_total"],
                **{k: float(m[k]) for k in ("succ", "mpjpe", "root_dist")}}}


def train_fix_std(dev) -> tuple:
    """Phase train_fix_std: one epoch of uhc_implicit at 1024 × 48 with a
    trainable log-std through K1 (run_train's checks), keeping that
    epoch's PPO batch; returns (launch counts, log-std move, the agent,
    the batch)."""
    import dataclasses

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn import agent as AG

    cfg = dataclasses.replace(Config.uhc_implicit(), fix_std=False)
    kept = {}

    def make(out):
        kept["agent"] = AG.CopycatAgent(cfg, "sample_data/gait_clips.pkl",
                                        num_envs=1024, horizon=48,
                                        results_dir=out, device=dev)
        kept["log_std0"] = kept["agent"].log_std.detach().clone()
        return kept["agent"]

    ppo = AG.ppo_update

    def keep_batch(*args, **kw):
        kept["batch"] = args[5]
        return ppo(*args, **kw)

    AG.ppo_update = keep_batch
    try:
        got = run_train(None, 1, "train_fix_std", dev, routed=("k1",),
                        agent_fn=make)
    finally:
        AG.ppo_update = ppo
    agent = kept["agent"]
    move = (agent.log_std.detach() - kept["log_std0"]).abs()
    if agent.log_std_opt is None or not float(move.max()) > 0:
        raise RuntimeError("train_fix_std: the log-std did not train")
    return got, {"max": float(move.max()), "mean": float(move.mean())}, \
        agent, kept["batch"]


def trpo_phase(agent, batch) -> dict:
    """Phase trpo: one TRPO update of the train_fix_std agent's policy and
    value net on that epoch's batch (49,152 rows), timed; launches no
    kernel."""
    import torch

    from uhc_tpu_torch.learn.trpo import make_trpo_update

    update = make_trpo_update(agent.policy, agent.value)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = update(agent.log_std, batch)
    accepted = bool(st["trpo_accepted"])
    ms = 1e3 * (time.perf_counter() - t0)
    got = counts()
    if any(got.values()):
        raise RuntimeError(f"trpo launched {got}")
    kl = float(st["kl"])
    if not (0.0 <= kl <= 1.01e-2) or not all(
            bool(torch.isfinite(v).all()) for v in st.values()):
        raise RuntimeError(f"trpo: {st}")
    return {"accepted": accepted, "kl": kl, "ms": ms,
            "surr_loss": float(st["surr_loss"]),
            "value_loss": float(st["value_loss"]),
            "rows": int(batch["states"].shape[0])}


def obs_families(dev) -> tuple:
    """Phase obs_families: one epoch at 1024 × OBS_HORIZON for each obs
    family and reward of OBS_FAMILIES (K1, K1f under the explicit config),
    then the transformer actor's forward and backward on the v4 agent's
    normalized observations. Returns (counts by family, numbers)."""
    import dataclasses

    import torch

    from uhc_tpu_torch.config.config import EXPLICIT, Config
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.agent import CopycatAgent

    got, numbers, agents = {}, {}, {}
    for obs_v, reward, name in OBS_FAMILIES:
        base = (Config.from_dict(name, EXPLICIT) if name == "explicit"
                else Config.uhc_implicit())
        cfg = dataclasses.replace(base, env=dataclasses.replace(
            base.env, obs_v=obs_v, reward_id=reward))
        fam = f"v{obs_v}"

        def make(out, cfg=cfg, fam=fam):
            agents[fam] = CopycatAgent(cfg, "sample_data/gait_clips.pkl",
                                       num_envs=1024, horizon=OBS_HORIZON,
                                       results_dir=out, device=dev)
            return agents[fam]

        phase(f"obs_families_{fam}", f"(obs v{obs_v}, {reward}, {name}: "
                                     f"1 epoch of 1024 × {OBS_HORIZON})")
        got[fam] = run_train(None, 1, f"obs_families_{fam}", dev,
                             routed=("k1f",) if name == "explicit"
                             else ("k1",), agent_fn=make)
        rates = TRAIN_RATES[f"obs_families_{fam}"]
        numbers[fam] = {"reward": reward, "cfg": name,
                        "obs_dim": agents[fam].obs_dim,
                        "rollout_env_steps_per_s":
                            rates["rollout_env_steps_per_s"][0],
                        "ppo_update_ms": rates["ppo_update_ms"][0]}
    # the transformer actor on the v4 tokens: 28 global features, 23 rows
    # of 26
    agent = agents["v4"]
    obs = RN.normalize(agent.rs, H.get_obs(
        agent.topo, agent.sim_model, agent.env_cfg, agent.env_states,
        agent.expert_lib))
    nt = agent.topo.nbody - 1
    pol = nets.make_policy(Config(actor_type="transformer"), obs.shape[1],
                           agent.action_dim,
                           torch.Generator().manual_seed(0), dev,
                           n_tokens=nt, token_dim=26)
    act = torch.randn(obs.shape[0], agent.action_dim, device=dev,
                      generator=torch.Generator(dev).manual_seed(1)) * 0.1
    log_std = torch.full((agent.action_dim,), -2.3, device=dev)

    def fwd_bwd():
        pol.zero_grad(set_to_none=True)
        loss = -nets.gaussian_log_prob(pol(obs), log_std, act).mean()
        loss.backward()
        return loss

    reset_counts()
    loss = fwd_bwd()
    ms = cuda_ms(fwd_bwd, 5)
    if any(counts().values()) or not bool(torch.isfinite(loss)) or not all(
            p.grad is not None and bool(torch.isfinite(p.grad).all())
            for p in pol.parameters()):
        raise RuntimeError("obs_families: transformer forward / backward "
                           "not finite")
    numbers["transformer"] = {
        "rows": int(obs.shape[0]), "obs_dim": int(obs.shape[1]),
        "tokens": nt, "params": sum(p.numel() for p in pol.parameters()),
        "loss": float(loss.detach()), "fwd_bwd_ms": ms}
    return got, numbers


def bound(flops, nbytes) -> dict:
    """The least time of `flops` float32 operations and `nbytes` of
    device memory traffic on the card: the larger of the two, and which."""
    t_op, t_by = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_op, t_by),
            "bound_by": "operations" if t_op >= t_by else "bytes"}


def remove_toe_tree(dev):
    """remove_toe's 22-body tree of the stand-in (smpl/local_robot.py) ->
    (topo, model on `dev`, expert library of the gait clips mapped
    through SMPLConverter, the converter's (jpos, body) diff weights)."""
    import numpy as np
    import torch

    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.converter import SMPLConverter
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid
    from uhc_tpu_torch.smpl.local_robot import remove_toe_model

    t24, m24 = load_fixture_humanoid()
    topo, m_np = remove_toe_model(t24, m24)
    model = model_from_numpy(m_np, dev)
    conv = SMPLConverter(t24, topo)
    motion = load_motion_file("sample_data/gait_clips.pkl")
    lib, _ = build_expert_library(topo, model, motion, converter=conv,
                                  base_root_offset=np.asarray(
                                      m24.body_pos)[0])
    jpw = torch.as_tensor(conv.get_new_diff_weight().astype(np.float32),
                          device=dev)
    return topo, model, lib, (jpw, jpw[1:].contiguous())


def toe_library(model, rows: int = 2):
    """`rows` remove_toe models that differ only in body_mass (a leaf K1e
    gathers), scaled from 1 to 1.25."""
    import dataclasses

    import torch

    return dataclasses.replace(model, body_mass=torch.stack(
        [model.body_mass * s for s in torch.linspace(1.0, 1.25, rows)
         .tolist()]))


def launched(name, want_counts, out):
    """Fail unless the launches since reset_counts() are `want_counts`
    and every output is finite."""
    import torch

    torch.cuda.synchronize()
    if counts() != want_counts or not all(bool(torch.isfinite(t).all())
                                          for t in out):
        raise RuntimeError(f"{name}: launches {counts()} (expected "
                           f"{want_counts}) or output not finite")


def remove_toe_check(topo, model, lib, dev) -> tuple:
    """The 22-body kernels against their float32 and float64 plain
    versions on B_CHECK clip-frame states of the tree (plain PD and
    meta-PD): K1-22 at (1, 2) by `gate`; K2-22 at PCG-2, its tail by
    `gate`, its head's state by `gate` against the plain head and its
    Xp/Xf by `x_check`, head + tail equal to K1-22 at (2, 2) bit for bit;
    K1e-22 over the 2-model `toe_library` by `gate`; K1f-22 under the
    explicit config by `gate`, one env in K1F_LOWERED lowered; one launch
    each -> (errors, failures)."""
    import dataclasses

    import torch

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    gen = torch.Generator().manual_seed(31)
    errs, fails = {}, []
    plain_env = Config.uhc_implicit().env
    lib2 = toe_library(model)
    for mode, env in (("plain_pd", plain_env),
                      ("meta_pd", dataclasses.replace(plain_env,
                                                      meta_pd=True))):
        step = CS.ControlStep(topo, env, model, (1, 2))
        qpos, qvel, tb = draw_big_states(lib, topo.nv, B_CHECK, gen, dev)
        act = (0.02 * torch.randn((B_CHECK, step.act_dim),
                                  generator=gen)).to(dev)
        ins = (qpos, qvel, act, tb)
        reset_counts()
        out = step(*ins, 1.0)
        launched(f"K1-22 {mode}", expect(1, "k1_22"), out)
        e, f = gate(f"K1-22 {mode}", out, *plain_pair(topo, env, model, ins,
                                                     (1, 2)))
        errs[f"k1_{mode}"], fails = e, fails + f

        split = K2.ControlStepSplit(topo, env, model, 2)
        reset_counts()
        qh, vh, X = split.head(*ins, 1.0)
        q2, v2 = split.tail(qh, vh, act, tb, X, 1.0)
        launched(f"K2-22 {mode}", expect(1, "k2_head_22", "k2_tail_22"),
                 (q2, v2, X))
        q1, v1 = CS.ControlStep(topo, env, model, (2, 2))(*ins, 1.0)
        torch.cuda.synchronize()
        if not (torch.equal(q1, q2) and torch.equal(v1, v2)):
            raise RuntimeError(
                f"K2-22 {mode}: head + tail differ from K1-22 at (2, 2): "
                f"|dqpos| {(q1 - q2).abs().max().item()}, |dqvel| "
                f"{(v1 - v2).abs().max().item()}")
        e, f = gate(f"K2-22 tail {mode}", (q2, v2),
                    *plain_pair(topo, env, model, ins, (2, 2)))
        h32, h64 = head_references(topo, env, model, ins)
        eh, fh = gate(f"K2-22 head {mode}", (qh, vh), h32[:2], h64[:2])
        e.update(x_check(f"K2-22 {mode}", X, h32[2], h64[2], f), head=eh,
                 split_equals_k1=True)
        errs[f"k2_{mode}"], fails = e, fails + f + fh

        seq = (torch.arange(B_CHECK, dtype=torch.int32) % 2).to(dev)
        reset_counts()
        e, f = k1e_check(topo, env, lib2, (*ins, seq), f"22 bodies {mode}")
        launched(f"K1e-22 {mode}", expect(1, "k1e_22"), ())
        errs[f"k1e_{mode}"], fails = e, fails + f

    env = k1f_modes()["explicit"]
    step = CS.ControlStep(topo, env, model, (1, 2))
    ins = k1f_draw(topo, env, lib, B_CHECK, gen, dev)
    reset_counts()
    out = step(*ins, 1.0)
    launched("K1f-22 explicit", expect(1, "k1f_22"), out)
    e, f = gate("K1f-22 explicit", out, *plain_pair(topo, env, model, ins,
                                                   (1, 2)))
    e["act_dim"] = step.act_dim
    errs["k1f_explicit"], fails = e, fails + f
    return errs, fails


# the rollouts of phase remove_toe: the route's name, its config and
# UHC_TPU_LANE, whether it runs over a model library, its counters
TOE_ROLLOUTS = (("k1", "uhc_implicit", None, False, ("k1_22",)),
                ("k1f", "explicit", None, False, ("k1f_22",)),
                ("k1e", "uhc_implicit", None, True, ("k1e_22",)),
                ("k2", "uhc_implicit", "0", False,
                 ("k2_head_22", "k2_tail_22")))


def toe_rollouts(topo, model, lib, diffw, dev) -> dict:
    """The env's main path on remove_toe's tree, once per route:
    `make_env_step_batched(topo, cfg, fused_model=...)` through
    learn/rollout.py, SMPLX_ROLLOUT envs × steps with a fresh seeded policy
    at the config's widths and the converter's (jpos, body) diff weights
    `diffw`: K1-22 at the default routing, K1f-22 under `explicit`, K1e-22
    over a `toe_library` of one row per clip, K2-22 under UHC_TPU_LANE=0;
    one launch of the route's kernels per step, none of any other and no
    call of the plain chain; finite rewards and observations -> {route:
    numbers}."""
    import torch

    from uhc_tpu_torch.config.config import EXPLICIT, Config
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.rollout import init_env_states, make_rollout_fn
    from uhc_tpu_torch.physics import solver

    B, T = SMPLX_ROLLOUT
    out = {}
    jpw, bdw = diffw
    for route, cfg_name, lane, library, routed in TOE_ROLLOUTS:
        fused = (toe_library(model, lib["len"].shape[0]) if library
                 else model)
        cfg = (Config.from_dict("explicit", EXPLICIT)
               if cfg_name == "explicit" else Config.uhc_implicit())
        env = cfg.env
        obs_dim = H.obs_dim(topo, env)
        act_dim = sum(H.action_dims(topo, env))
        if lane is not None:
            os.environ["UHC_TPU_LANE"] = lane
        try:
            rollout = make_rollout_fn(
                topo, env, nets.make_policy(
                    cfg, obs_dim, act_dim, torch.Generator().manual_seed(32),
                    dev), T, fused_model=fused)
        finally:
            os.environ.pop("UHC_TPU_LANE", None)
        aux = {"neutral_qpos": lib["qpos"][0, 0],
               "neutral_qvel": torch.zeros(topo.nv, device=dev),
               "jpos_diffw": jpw, "body_diffw": bdw}
        gen = torch.Generator(device=dev).manual_seed(32)
        states = init_env_states(topo, env, fused, lib, aux, gen, B)
        plain_calls = []
        plain = solver.do_simulation

        def counted(*a, **k):
            plain_calls.append(1)
            return plain(*a, **k)

        reset_counts()
        solver.do_simulation = counted
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, traj, last = rollout(
                fused, lib, aux,
                torch.full((act_dim,), cfg.log_std, device=dev),
                RN.init(obs_dim, dev), states, gen, 1.0, 1.0,
                torch.zeros(lib["len"].shape[0], device=dev))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            solver.do_simulation = plain
        got = counts()
        if got != expect(T, *routed) or plain_calls:
            raise RuntimeError(f"remove_toe rollout {route}: launches {got}, "
                               f"plain chain calls {len(plain_calls)}")
        if not all(bool(torch.isfinite(t).all()) for t in (
                traj.rewards, traj.states, last)):
            raise RuntimeError(f"remove_toe rollout {route}: rewards or "
                               "observations not finite")
        out[route] = {"launches": {k: got[k] for k in routed},
                      "cfg": cfg_name, "num_envs": B, "horizon": T,
                      "obs_dim": obs_dim, "action_dim": act_dim,
                      "env_steps_per_s": B * T / secs, "seconds": secs,
                      "reward_mean": traj.rewards.mean().item(),
                      "episodes_done": int(traj.dones.sum()),
                      "plain_chain_calls": 0}
    return out


def toe_times(topo, model, lib, dev) -> dict:
    """K1-22 at (1, 2), K1f-22 (explicit), K1e-22 over the 2-model
    library and K2-22's head and tail at PCG-2 timed at B_TIME on
    clip-frame states of the tree, each with its plain version's time and
    its bound (`control_step_flops` of this draw's contacts; the bytes of
    its inputs and outputs once, K2's Xp/Xf round trip included)."""
    import torch

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2
    from uhc_tpu_torch.physics import solver as SV
    from uhc_tpu_torch.physics.model import model_gather

    gen = torch.Generator().manual_seed(33)
    env = Config.uhc_implicit().env
    B = B_TIME
    qpos, qvel, tb = draw_big_states(lib, topo.nv, B, gen, dev)
    k1 = CS.ControlStep(topo, env, model, (1, 2))
    act = (0.02 * torch.randn((B, k1.act_dim), generator=gen)).to(dev)
    seq = (torch.arange(B, dtype=torch.int32) % 2).to(dev)
    lib2 = toe_library(model)
    k1e = CS.ControlStep(topo, env, lib2, (1, 2))
    split = K2.ControlStepSplit(topo, env, model, 2)
    envf = k1f_modes()["explicit"]
    k1f = CS.ControlStep(topo, envf, model, (1, 2))
    insf = k1f_draw(topo, envf, lib, B, gen, dev)
    ins = (qpos, qvel, act, tb)

    def io(step, extra=0, a=act):
        return 4 * (qpos.numel() * 2 + qvel.numel() * 2 + a.numel()
                    + tb.numel() + step.params.size + step.itab.size
                    + extra)

    def traced(env_cfg, m, args, pcg):
        trace = []
        SV.do_simulation(topo, env_cfg, m, *args, 1.0, pcg, trace=trace)
        return trace

    out = {"bodies": topo.nbody, "nv": topo.nv, "B": B}
    k1(*ins, 1.0)
    k1e(*ins, 1.0, seq)
    k1f(*insf, 1.0)
    qh, vh, X = split.head(*ins, 1.0)
    split.tail(qh, vh, act, tb, X, 1.0)
    torch.cuda.synchronize()
    out["k1"] = {
        "ms": cuda_ms(lambda: k1(*ins, 1.0), 10),
        "plain_ms": cuda_ms(lambda: CS.control_step_reference(
            topo, env, model, *ins, 1.0, (1, 2)), 2),
        "bound": bound(CS.control_step_flops(
            topo, env, traced(env, model, ins, (1, 2)), (1, 2)), io(k1))}
    gathered = model_gather(lib2, seq.long())
    out["k1e"] = {
        "ms": cuda_ms(lambda: k1e(*ins, 1.0, seq), 10),
        "plain_ms": cuda_ms(lambda: CS.control_step_reference(
            topo, env, lib2, *ins, 1.0, (1, 2), seq), 2),
        "bound": bound(CS.control_step_flops(
            topo, env, traced(env, gathered, ins, (1, 2)), (1, 2)),
            io(k1e, B))}
    vfx, gains = CS.k1f_operands(topo, envf, model, insf[2])
    operands = sum(x.numel() for x in (vfx, gains) if x is not None)
    out["k1f"] = {
        "ms": cuda_ms(lambda: k1f(*insf, 1.0), 10),
        "plain_ms": cuda_ms(lambda: CS.control_step_reference(
            topo, envf, model, *insf, 1.0, (1, 2)), 2),
        "bound": bound(CS.control_step_flops(
            topo, envf, traced(envf, model, insf, (1, 2)), (1, 2)),
            io(k1f, operands, insf[2]))}
    trace2 = traced(env, model, ins, (2, 2))
    out["k2"] = {
        "head_ms": cuda_ms(lambda: split.head(*ins, 1.0), 10),
        "tail_ms": cuda_ms(lambda: split.tail(qh, vh, act, tb, X, 1.0), 10),
        "plain_head_ms": cuda_ms(lambda: K2.head_reference(
            topo, env, model, *ins, 1.0, 2), 2),
        "plain_tail_ms": cuda_ms(lambda: K2.tail_reference(
            topo, env, model, qh, vh, act, tb, X, 1.0, 2), 2),
        "bound": {part: bound(CS.control_step_flops(
            topo, env, tr, (2, 2), start), io(split, X.numel()))
            for part, tr, start in (("head", trace2[:1], 0),
                                    ("tail", trace2[1:], 1))}}
    for k in ("k1", "k1e", "k1f"):
        out[k]["substeps_per_s"] = B * env.frame_skip / (out[k]["ms"] / 1e3)
    return out


def variant_draws(topo, model, lib, dev):
    """The draws of the variant check, one variant after another: (name,
    variant model on `dev`, (qpos, qvel, actions, target_base)) of B_CHECK
    gait-frame states for the capsule_model and box_feet_model variants
    of the stand-in (smpl/local_robot.py: the contact sets change, the
    tree does not), made on the host from one seeded generator."""
    import torch

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.physics.solver import action_dims
    from uhc_tpu_torch.smpl import local_robot as L

    gen = torch.Generator().manual_seed(34)
    n_act = sum(action_dims(topo, Config.uhc_implicit().env))
    for name in ("capsule", "box_feet"):
        vmodel = model_from_numpy(getattr(L, f"{name}_model")(topo, model),
                                  dev)
        qpos, qvel, tb = draw_states(lib, B_CHECK, gen, dev)
        act = (0.02 * torch.randn((B_CHECK, n_act), generator=gen)).to(dev)
        yield name, vmodel, (qpos, qvel, act, tb)


def variant_check(topo, model, lib, dev) -> dict:
    """K1 (24 bodies, (1, 2)) over the capsule_model and box_feet_model
    variants on `variant_draws` against its float32 and float64 plain
    versions -> (errors, failures). box_feet is held by `gate`. capsule
    by `gate_big` (witnesses at (1, 2)): env 230 of its draws is a state
    where the (1, 2) step grows a 1-2-ulp move of the state past the
    bounds (a stale preconditioner under few PCG iterations, no contact
    switch), so every float32 computation of it, the plain version's too,
    lands off the float64 one and off the others; the host build of K1
    fails `gate` there and passes `gate_big`
    (tests/test_torch_variant_gate.py)."""
    import torch

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.physics import control_step as CS

    env = Config.uhc_implicit().env
    errs, fails = {}, []
    for name, vmodel, ins in variant_draws(topo, model, lib, dev):
        step = CS.ControlStep(topo, env, vmodel, (1, 2))
        reset_counts()
        out = step(*ins, 1.0)
        launched(f"K1 {name}", expect(1, "k1"), out)
        plain = plain_pair(topo, env, vmodel, ins, (1, 2))
        if name == "capsule":
            e, f = gate_big(f"K1 {name}", out, *plain, lambda ev, m=vmodel,
                            ins=ins: [moved_steps(topo, env, m, ins, ev, dt,
                                                  pcg_iters=(1, 2))
                                      for dt in (torch.float64,
                                                 torch.float32)])
        else:
            e, f = gate(f"K1 {name}", out, *plain)
        e["contact_points"] = int(vmodel.contact_mask.sum().item())
        errs[name], fails = e, fails + f
    return errs, fails


def toe_rows(src, k2_src, errs, rollouts, t) -> list:
    """The kernels-line rows of the 22-body kernels: launches from phase
    remove_toe's rollouts, errors from its checks, times `t` at
    B_TIME."""
    def err(prefix, key=None):
        return max(v for m, e in errs.items() if m.startswith(prefix)
                   for y in ("kernel_vs_plain64", "kernel_vs_plain32")
                   for v in (e if key is None else e[key])[y])

    rows = [("control_step_remove_toe", "uhc_tpu/physics/pallas_lane.py:83",
             rollouts["k1"]["launches"]["k1_22"], err("k1_"), t["k1"]),
            ("control_step_explicit_remove_toe",
             "uhc_tpu/physics/pallas_lane.py:127",
             rollouts["k1f"]["launches"]["k1f_22"], err("k1f_"), t["k1f"]),
            ("control_step_per_env_remove_toe",
             "uhc_tpu/physics/pallas_lane.py:176",
             rollouts["k1e"]["launches"]["k1e_22"], err("k1e_"), t["k1e"])]
    out = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": e, "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"]["bound_ms"],
            "bound_by": tm["bound"]["bound_by"], "library_ms": None}
           for name, rep, n, e, tm in rows]
    for part in ("head", "tail"):
        out.append({
            "name": f"control_step_{part}_remove_toe", "route": "cuda",
            "source": src, "replaces": k2_src,
            "launches": rollouts["k2"]["launches"][f"k2_{part}_22"],
            "max_abs_err": err("k2_", "head" if part == "head" else None),
            "ms": t["k2"][f"{part}_ms"],
            "plain_ms": t["k2"][f"plain_{part}_ms"],
            "bound_ms": t["k2"]["bound"][part]["bound_ms"],
            "bound_by": t["k2"]["bound"][part]["bound_by"],
            "library_ms": None})
    return out


# the kinematic-policy stack, scene objects and the mesh toolkit (phases
# meshtools, uhm, objects): the native toolkit against its numpy path at
# the CPU test's bounds (tests/test_torch_meshtools.py: the native sums of
# float32 coordinates); the run of tools/train_queue_r3c.sh:22-25 (256
# envs × 24 steps) cut in depth to UHM_EPOCHS and eval_relive to the clips'
# first UHM_EVAL_FRAMES frames (the exact chain takes ~1.3 s a control
# step on the card, launch-bound: PERF.md §6); a 512 × 32 rollout
# over a library with an object track, and the exact chain's batch of the
# kin env and of a dynamic box at B_CHECK
MESH_MASS_RTOL, MESH_COM_ATOL, MESH_INERTIA_RTOL = 1e-12, 1e-6, 1e-3
UHM_TRAIN_ARGS = ["--cfg", "uhm_1", "--agent", "uhm", "--num-envs", "256",
                  "--horizon", "12"]
# one epoch of 12 steps and 4 eval frames (2 epochs of 24 and 16 frames
# before the tools phase, 24 steps and 8 frames before the data_parallel
# phase came): the whole run's time on a slow host
UHM_EPOCHS, UHM_EVAL_FRAMES = 1, 4
OBJ_ROLLOUT = (512, 32)
OBJ_BOX = {"kind": "box", "size": [0.15, 0.15, 0.15], "mass": 2.0}


def meshtools_phase() -> dict:
    """Phase meshtools: build the native toolkit (g++), read the
    stand-in's meshes both ways (triangles equal) and compare the mass
    properties with the numpy path at the CPU test's bounds; the stand-in
    built on the native path."""
    import tempfile

    import numpy as np

    from uhc_tpu_torch.native import meshtools
    from uhc_tpu_torch.smpl import mesh
    from uhc_tpu_torch.smpl.fixture_humanoid import write_fixture_humanoid
    from uhc_tpu_torch.smpl.mjcf import load_mjcf_humanoid

    t0 = time.perf_counter()
    meshtools.load()
    build_s = time.perf_counter() - t0
    worst = {"mass_rel": 0.0, "com_m": 0.0, "inertia_rel": 0.0}
    with tempfile.TemporaryDirectory() as d:
        xml = write_fixture_humanoid(d)
        files = sorted(f for f in os.listdir(d) if f.endswith(".stl"))
        tris_n = 0
        for f in files:
            path = os.path.join(d, f)
            tris = mesh.load_stl(path)
            if not np.array_equal(tris, mesh.load_stl(path, native=False)):
                raise RuntimeError(f"meshtools: {f} reads differently")
            tris_n += len(tris)
            m, com, inertia = mesh.mesh_mass_properties(tris)
            m0, com0, inertia0 = mesh.mesh_mass_properties(tris,
                                                           native=False)
            worst["mass_rel"] = max(worst["mass_rel"], abs(m - m0) / m0)
            worst["com_m"] = max(worst["com_m"],
                                 float(np.abs(com - com0).max()))
            worst["inertia_rel"] = max(worst["inertia_rel"], float(
                np.abs(inertia - inertia0).max() / np.abs(inertia0).max()))
        t0 = time.perf_counter()
        _, native_model = load_mjcf_humanoid(xml)
        load_s = time.perf_counter() - t0
    if not (worst["mass_rel"] <= MESH_MASS_RTOL
            and worst["com_m"] <= MESH_COM_ATOL
            and worst["inertia_rel"] <= MESH_INERTIA_RTOL):
        raise RuntimeError(f"meshtools: native vs numpy {worst}")
    if not np.isfinite(native_model.body_inertia).all():
        raise RuntimeError("meshtools: the native stand-in is not finite")
    return {"build_s": build_s, "files": len(files), "triangles": tris_n,
            "native_vs_numpy": worst, "native_stand_in_s": load_s,
            "bounds": [MESH_MASS_RTOL, MESH_COM_ATOL, MESH_INERTIA_RTOL]}


def seeded_cc_checkpoint(cfg, seed: int = 41) -> dict:
    """A frozen copycat at the config's full width (MCP 8 × (784 → 512 →
    256 → 75)) with seeded running statistics, as a checkpoint dict."""
    import numpy as np
    import torch

    from uhc_tpu_torch.learn import nets

    pol = nets.make_policy(cfg, 784, 75, torch.Generator().manual_seed(seed),
                           "cpu")
    rng = np.random.default_rng(seed)
    return {"policy_params": nets.policy_to_numpy(pol),
            "running_stats": {
                "n": np.float32(1e4),
                "mean": (0.1 * rng.standard_normal(784)).astype(np.float32),
                "m2": (1e4 * (0.5 + rng.random(784))).astype(np.float32)}}


def kin_step_check(dev) -> tuple:
    """Phase uhm (a): one kin_env_step of B_CHECK envs at clip frames
    (seeded qvel noise), the actions of a seeded full-width kin net
    (KinNetSpecs of uhm_1, carried by kin_net_from_numpy) on their AR obs
    plus its noise, the frozen copycat a seeded full-width MCP through
    make_cc_policy_fn: the card in float32 against the same step on the
    host in float32 and on the card in float64, by `gate` at the exact
    chain's bounds; the step timed -> (numbers, failures)."""
    import dataclasses

    import torch

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.envs import humanoid_kin as K
    from uhc_tpu_torch.learn import kin_net as KN
    from uhc_tpu_torch.learn.agent_uhm import (kin_config, kin_net_specs,
                                               make_cc_policy_fn)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.constants import default_diff_weights
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    cfg = Config.preset("uhm_1")
    kc, specs = kin_config(cfg), kin_net_specs(cfg)
    topo, model_np = load_fixture_humanoid()
    ck = seeded_cc_checkpoint(cfg)
    gen = torch.Generator().manual_seed(42)
    net = KN.kin_net_init(topo, specs, gen, "cpu")
    net = KN.kin_net_from_numpy(KN.kin_net_to_numpy(net), specs, dev)
    jpw = torch.as_tensor(default_diff_weights()[0])

    def setup(device, dtype):
        model = model_from_numpy(model_np, device)
        lib = build_expert_library(topo, model, load_motion_file(
            "sample_data/gait_clips.pkl"))[0]
        if dtype == torch.float64:
            model = double_model(model)
            lib = {k: v.double() if v.is_floating_point() else v
                   for k, v in lib.items()}
        return model, lib, make_cc_policy_fn(ck, cfg, device, dtype)

    model, lib, cc = setup(dev, torch.float32)
    S = lib["len"].shape[0]
    seq = torch.randint(0, S, (B_CHECK,), generator=gen)
    t = (torch.rand(B_CHECK, generator=gen)
         * (lib["len"][seq].cpu() - 2)).long()
    qvel_noise = 0.05 * torch.randn((B_CHECK, topo.nv), generator=gen)
    act_noise = torch.randn((B_CHECK, 80), generator=gen)

    def states(model, lib, device):
        st = K.kin_env_reset(topo, model, kc, seq.to(device), lib)
        s, tt = seq.to(device), t.to(device)
        q = lib["qpos"][s, tt]
        return dataclasses.replace(
            st, qpos=q, prev_qpos=q, target_qpos=q, start_ind=tt,
            qvel=lib["qvel"][s, tt] + qvel_noise.to(device, q.dtype))

    st = states(model, lib, dev)
    with torch.no_grad():
        obs = K.get_ar_obs_v1(topo, model, cfg.env, st, lib)
        mean, _ = net(obs, torch.zeros((B_CHECK, specs.rnn_hdim),
                                       device=dev))
        act = mean + torch.exp(net.log_std) * act_noise.to(dev)
        out = K.kin_env_step(topo, model, kc, cfg.env, st, act, lib, cc,
                             jpw.to(dev))
        step_ms = cuda_ms(lambda: K.kin_env_step(
            topo, model, kc, cfg.env, st, act, lib, cc, jpw.to(dev)), 1)
        t0 = time.perf_counter()
        ref = {}
        for name, device, dtype in (("plain32", "cpu", torch.float32),
                                    ("plain64", dev, torch.float64)):
            m_, l_, c_ = setup(device, dtype)
            s_ = states(m_, l_, device)
            ref[name] = K.kin_env_step(
                topo, m_, kc, cfg.env, s_, act.to(device, dtype), l_, c_,
                jpw.to(device, dtype))
    errs, fails = gate("kin_env_step", (out[0].qpos, out[0].qvel),
                       [ref["plain32"][0].qpos.to(dev),
                        ref["plain32"][0].qvel.to(dev)],
                       [ref["plain64"][0].qpos, ref["plain64"][0].qvel])
    plain_s = time.perf_counter() - t0
    reward_err = (out[2].double() - ref["plain64"][2]).abs().max().item()
    if not all(bool(torch.isfinite(x).all()) for x in (
            out[0].qpos, out[0].qvel, *out[1:4])):
        fails.append("kin_env_step: output not finite")
    return {**errs, "reward_vs_plain64": reward_err, "step_ms": step_ms,
            "plain_steps_s": plain_s, "num_envs": B_CHECK,
            "done": int(out[4].sum())}, fails


def uhm_phase(dev) -> tuple:
    """Phase uhm: (a) `kin_step_check`; (b) cli/train --cfg uhm_1 --agent
    uhm at 256 envs × 24 steps (tools/train_queue_r3c.sh:22-25), UHM_EPOCHS
    with rl_update and full_update, a seeded frozen copycat (the trained
    one stays off the card), no kernel launched (the exact chain, as in the
    JAX package), finite stats, the checkpoint reloading to the same kin
    net; (c) cli/eval_relive of that checkpoint over the six gait clips'
    first UHM_EVAL_FRAMES frames -> (numbers, failures)."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from uhc_tpu_torch.cli import eval_relive, train
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn import kin_net as KN

    step, fails = kin_step_check(dev)
    with tempfile.TemporaryDirectory() as out:
        cc_path = os.path.join(out, "cc.p")
        with open(cc_path, "wb") as f:
            pickle.dump(seeded_cc_checkpoint(Config.preset("uhm_1")), f)
        reset_counts()
        agent, hist = train.main(UHM_TRAIN_ARGS + [
            "--epochs", str(UHM_EPOCHS), "--results-dir", out,
            "--cc-checkpoint", cc_path])
        torch.cuda.synchronize()
        if counts() != expect(0):
            fails.append(f"uhm train: launches {counts()}, expected none")
        for i, st in enumerate(hist):
            if not all(np.isfinite(v) for v in st.values()):
                fails.append(f"uhm train: epoch {i} stats {st}")
        ck = KN.kin_net_to_numpy(agent.net)
        with open(agent.checkpoint_path(UHM_EPOCHS), "rb") as f:
            saved = pickle.load(f)["params"]
        x = torch.randn((agent.num_envs, 640),
                        generator=torch.Generator().manual_seed(5)).to(dev)
        h = torch.zeros((agent.num_envs, 512), device=dev)
        with torch.no_grad():
            same = all(torch.equal(a, b) for a, b in zip(
                KN.kin_net_from_numpy(saved, agent.specs, dev)(x, h),
                agent.net(x, h)))
        finite = all(bool(np.isfinite(np.asarray(v)).all())
                     for v in _flat(ck))
        if not (same and finite):
            fails.append(f"uhm train: checkpoint reload equal {same}, "
                         f"finite {finite}")
        reset_counts()
        res = eval_relive.main([
            "--epoch", str(UHM_EPOCHS), "--results-dir", out,
            "--cc-checkpoint", cc_path, "--max-seq-len",
            str(UHM_EVAL_FRAMES)])
        if counts() != expect(0) or not all(
                np.isfinite(v) for v in res["summary"].values()) or tuple(
                res["traj"]["pred_qpos"].shape) != (6, UHM_EVAL_FRAMES - 1,
                                                    76):
            fails.append(f"eval_relive: launches {counts()}, summary "
                         f"{res['summary']}")
    return {"kin_step": step, "epochs": len(hist),
            "num_envs": agent.num_envs, "horizon": agent.horizon,
            "rollout_env_steps_per_s": [st["rollout_steps_per_sec"]
                                        for st in hist],
            "rl_update_ms": [1e3 * st["T_rl_update"] for st in hist],
            "full_update_ms": [1e3 * st["T_full_update"] for st in hist],
            "epoch_s": [st["T_total"] for st in hist],
            "reward_mean": [st["reward_mean"] for st in hist],
            "supervised_loss": [st["supervised_loss"] for st in hist],
            "checkpoint_finite": finite, "checkpoint_equal": same,
            "eval_control_steps": res["control_steps"],
            "eval_ms_per_step": res["ms_per_step"],
            "eval_summary": res["summary"]}, fails


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def obj_library(topo, model):
    """The gait clips, the first three with a box sliding along +x at
    0.25 m (a free-joint track) -> (expert library, keys)."""
    import numpy as np

    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)

    seqs = load_motion_file("sample_data/gait_clips.pkl")
    for k in list(seqs)[:3]:
        T = len(np.asarray(seqs[k]["pose_aa"]))
        track = np.zeros((T, 7), np.float32)
        track[:, 0] = np.linspace(0.5, 1.5, T)
        track[:, 2], track[:, 3] = 0.25, 1.0
        seqs[k]["obj_pose"] = track
    return build_expert_library(topo, model, seqs)


def objects_phase(topo, model, model_np, dev) -> tuple:
    """Phase objects: (a) learn/rollout.py's rollout of OBJ_ROLLOUT envs ×
    steps over a library with an object track, a seeded full-width MCP:
    one K1 launch a step, the carried track equal to the library's at each
    env's frame; (b) K1 on B_CHECK of the rollout's final states against
    its plain versions by `gate`; (c) a dynamic box on the exact chain:
    one control step of B_CHECK envs (a box at each left thigh) on the card
    against the host's float32 and the card's float64 step by `gate`, the
    box's dofs part of the state held, the step timed with and without
    the box; a box dropped from 0.5 m settling in 2 s -> (numbers,
    failures, K1 launches). The box step's `gate` takes witnesses: a
    humanoid sphere whose center sits within a few μm outside a box face
    meets the face normal's steep part (q / sqrt(q² + 1e-12), as in the
    JAX package), where float32 rounding of the state moves the contact
    force along a continuum, and the card's step can land on neither
    plain version (tests/test_torch_box_gate.py: such an env of this
    draw); there a host plain step from the state moved by 1-2 float32
    ulps must land on the card's answer."""
    import numpy as np
    import torch

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import neutral_from_library
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.rollout import init_env_states, make_rollout_fn
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import engine as E
    from uhc_tpu_torch.physics import objects as O
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.constants import default_diff_weights

    cfg = Config.uhc_implicit()
    env = cfg.env
    lib, keys = obj_library(topo, model)
    jpw, bdw = default_diff_weights()
    nq, nv = neutral_from_library(lib)
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.as_tensor(jpw, device=dev),
           "body_diffw": torch.as_tensor(bdw, device=dev)}
    gen = torch.Generator(device=dev).manual_seed(43)
    pol = nets.make_policy(cfg, H.obs_dim(topo, env), 75,
                           torch.Generator().manual_seed(43), dev)
    B, T = OBJ_ROLLOUT
    states = init_env_states(topo, env, model, lib, aux, gen, B)
    rollout = make_rollout_fn(topo, env, pol, T, fused_model=model)
    reset_counts()
    t0 = time.perf_counter()
    states, _, traj, _ = rollout(model, lib, aux, torch.full((75,), -2.3,
                                                             device=dev),
                                 RN.init(H.obs_dim(topo, env), dev), states,
                                 gen, 1.0, 1.0, torch.zeros(len(keys),
                                                            device=dev))
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launched("objects rollout", expect(T, "k1"),
             (states.qpos, states.qvel, traj.rewards))
    k1_launches = counts()["k1"]
    frame = torch.minimum(states.start_ind + states.cur_t,
                          lib["len"][states.seq_idx] - 1)
    track_equal = torch.equal(states.obj_qpos,
                              lib["obj_pose"][states.seq_idx, frame])
    fails = [] if track_equal else ["objects rollout: the carried track is "
                                    "not the library's"]
    moving = int((lib["obj_pose"][states.seq_idx, 0, 0]
                  != states.obj_qpos[:, 0]).sum())

    # (b) K1 on the rollout's states
    sel = slice(0, B_CHECK)
    qpos, qvel = states.qpos[sel].contiguous(), states.qvel[sel].contiguous()
    tb = lib["qpos"][states.seq_idx[sel], torch.minimum(
        frame[sel] + 1, lib["len"][states.seq_idx[sel]] - 1), 7:].contiguous()
    g = torch.Generator().manual_seed(44)
    act = (0.02 * torch.randn((B_CHECK, 75), generator=g)).to(dev)
    step = CS.ControlStep(topo, env, model, pcg_iters=(1, 2))
    out = step(qpos, qvel, act, tb, 1.0)
    plain32 = [x.to(dev) for x in CS.control_step_reference(
        topo, env, model_from_numpy(model_np, "cpu"), qpos.cpu(),
        qvel.cpu(), act.cpu(), tb.cpu(), 1.0, (1, 2))]
    plain64 = CS.control_step_reference(
        topo, env, double_model(model), qpos.double(), qvel.double(),
        act.double(), tb.double(), 1.0, (1, 2))
    k1_errs, f = gate("objects K1", out, plain32, plain64)
    fails += f

    # (c) a dynamic box at each thigh on the exact chain; the box's dofs
    # join the state that the gate holds (the reference appends them to
    # the sim's qpos / qvel)
    kin = E.fk(topo, model, qpos)
    oq = torch.cat([kin["xpos"][:, 1] + torch.tensor([0.05, 0.0, 0.0],
                                                     device=dev),
                    torch.tensor([1.0, 0, 0, 0], device=dev).expand(
                        B_CHECK, 4)], 1)
    ov = torch.zeros((B_CHECK, 6), device=dev)
    box_ins = (qpos, qvel, act, tb, oq, ov)
    models = {(dev, torch.float32): model,
              ("cpu", torch.float32): model_from_numpy(model_np, "cpu"),
              (dev, torch.float64): double_model(model)}
    models["cpu", torch.float64] = double_model(models["cpu", torch.float32])

    def box_step(ins, device, dtype, obj=True):
        m = models[str(device) if device == "cpu" else device, dtype]
        qp, qv, a, t, q, v = (x.to(device, dtype) for x in ins)
        with torch.no_grad():
            if not obj:
                return H.do_simulation(topo, m, env, qp, qv, a, t, 1.0)
            out = H.do_simulation(
                topo, m, env, qp, qv, a, t, 1.0,
                obj=(O.make_obj_model([OBJ_BOX], device, dtype), q, v))
        return (torch.cat([out[0], out[2]], 1).to(dev),
                torch.cat([out[1], out[3]], 1).to(dev))

    obj_out = box_step(box_ins, dev, torch.float32)
    obj_ms = cuda_ms(lambda: box_step(box_ins, dev, torch.float32), 1)
    exact_ms = cuda_ms(lambda: box_step(box_ins, dev, torch.float32, False),
                       1)
    t0 = time.perf_counter()
    ref32 = box_step(box_ins, "cpu", torch.float32)
    ref64 = box_step(box_ins, dev, torch.float64)

    def moved(e):
        """The host's float64 and float32 steps of env e from its state
        (body and box) moved by 1-2 float32 ulps."""
        return [box_step(ulp_moved(box_ins, e, dtype, moved=(0, 1, 4, 5)),
                         "cpu", dtype)
                for dtype in (torch.float64, torch.float32)]

    obj_errs, f = gate("dynamic box step", obj_out, ref32, ref64, moved)
    plain_s = time.perf_counter() - t0
    fails += f
    box = {"boxes_moved": int(((obj_out[0][:, -7:] - oq).abs().amax(1)
                               > 1e-4).sum())}
    if not all(bool(torch.isfinite(x).all()) for x in obj_out):
        fails.append("dynamic box step: not finite")

    qp = torch.tensor([[[0.0, 0.0, 0.5, 1.0, 0.0, 0.0, 0.0]]], device=dev)
    qv = torch.zeros((1, 1, 6), device=dev)
    z3 = torch.zeros((1, 1, 3), device=dev)
    box_om = O.make_obj_model([OBJ_BOX], dev)
    for _ in range(900):
        qp, qv = O.obj_substep(model, box_om, qp, qv, z3, z3)
    qp, qv = qp[0, 0].cpu().numpy(), qv[0, 0].cpu().numpy()
    settled = bool(abs(qp[2] - 0.15) < 0.02 and np.all(np.abs(qv) < 0.05)
                   and np.all(np.abs(qp[:2]) < 0.01) and qp[3] > 0.99)
    if not settled:
        fails.append(f"box drop: rest {qp}, velocity {qv}")
    return {"rollout": {"num_envs": B, "steps": T, "k1_launches": k1_launches,
                        "env_steps_per_s": B * T / rollout_s,
                        "track_equal": track_equal,
                        "envs_on_a_moved_box": moving},
            "k1": k1_errs, "box_step": {**obj_errs, **box},
            "box_step_ms": obj_ms, "exact_step_ms": exact_ms,
            "box_plain_and_witness_s": plain_s,
            "num_envs": B_CHECK, "box_drop_rest": qp.tolist(),
            "box_drop_settled": settled}, fails, k1_launches


# phase tools: the data-preparation and inspection tools. AMASS corpora, one
# per split (train, vald, test); clip i of the gait clips goes to corpus
# i % 3, repeated AMASS_REPEAT times in time at AMASS_FR, so the 30 Hz
# resampling gives the clip back
AMASS_CORPORA = ("CMU", "HumanEva", "Transitions_mocap")
AMASS_REPEAT, AMASS_FR = 4, 120
TOOLS_EVAL_SPLIT = "train"
# CameraFit over one gait clip: its first CAMFIT_FRAMES frames, a camera
# CAMFIT_DEPTH m in front of the body looking along +y, plain gradient
# steps from a seeded perturbation of the true pose
CAMFIT_CLIP, CAMFIT_FRAMES, CAMFIT_STEPS = "0-SYN_walk_forward", 239, 50
CAMFIT_LR, CAMFIT_DEPTH, CAMFIT_NOISE = 8.0, 4.0, 0.05
# the card against the port on the CPU: losses relative to the loss,
# gradients relative to the largest entry (float32 sums in either order
# over 239 frames)
CAMFIT_LOSS_RTOL, CAMFIT_GRAD_RTOL = 1e-4, 1e-3
# the zoo on the card against the port on the CPU, relative to the
# output's largest entry (float32 convolutions in another order, TF32 off)
ZOO_RTOL = 1e-4
ZOO_IMAGE, ZOO_BATCH, ZOO_FRAMES, ZOO_OBS = 224, 8, 32, 784
# FK of the dump's trajectories, card against CPU (m)
FK_ATOL = 1e-5
WINDOW, WINDOW_BATCH = 32, 256


def amass_raw(clips, seed: int = 31) -> tuple:
    """The synthetic AMASS sequences: {(corpus, subject, action): npz
    fields} of the clips (poses repeated AMASS_REPEAT× in time at
    AMASS_FR, padded to SMPL-H's 156 with seeded hand dofs, trans
    repeated, the clip's 16 betas), and {processed key: clip key}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    raw, keys = {}, {}
    for i, (key, d) in enumerate(clips.items()):
        corpus = AMASS_CORPORA[i % len(AMASS_CORPORA)]
        pose = np.repeat(np.asarray(d["pose_aa"], np.float64),
                         AMASS_REPEAT, 0)
        hands = 0.1 * rng.standard_normal((len(pose), 156 - pose.shape[1]))
        action = key.split("-", 1)[-1]
        raw[corpus, f"s{i}", action] = {
            "poses": np.concatenate([pose, hands], 1),
            "trans": np.repeat(np.asarray(d["trans"], np.float64),
                               AMASS_REPEAT, 0),
            "betas": np.asarray(d["beta"], np.float64).reshape(16),
            "mocap_framerate": np.asarray(float(AMASS_FR)),
            "gender": np.asarray("neutral")}
        keys[f"0-{corpus}_s{i}_{action}"] = key
    return raw, keys


def write_amass_dir(directory, raw) -> None:
    """AMASS's layout: <corpus>/<subject>/<action>.npz."""
    import numpy as np

    for (corpus, subject, action), fields in raw.items():
        os.makedirs(os.path.join(directory, corpus, subject), exist_ok=True)
        np.savez(os.path.join(directory, corpus, subject, f"{action}.npz"),
                 **fields)


def stand_in_smpl_file(directory) -> str:
    """A seeded SMPL model file consistent with the stand-in's skeleton
    (`synthetic_smpl_data_like`): grounding with it keeps the gait clips'
    pelvis near 0.9 m (the random `synthetic_smpl_data` regresses every
    joint near its mean vertex and sinks the pelvis to 0.49 m)."""
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data_like

    return save_model_file(
        synthetic_smpl_data_like(*load_fixture_humanoid(), rng_seed=32),
        os.path.join(directory, "smpl_stand_in.npz"))


def amass_check(paths, keys, clips, cpu_trans) -> list:
    """Each split holds its corpus' clips; the 30 Hz pose_aa[:, :72] is
    the clip's exactly, the pose 156 wide; x, y of trans exact, z moved by
    one constant, equal to the grounding on the CPU within 1e-6 m."""
    import numpy as np

    from uhc_tpu_torch.data.dataset import load_motion_file
    from uhc_tpu_torch.data.process_amass import AMASS_SPLIT_DICT

    fails = []
    for split, path in paths.items():
        db = load_motion_file(path)
        want = {k for k in keys if AMASS_SPLIT_DICT.get(
            k[2:].split("_s")[0]) == split}
        if set(db) != want:
            fails.append(f"process_amass {split}: {sorted(db)} != "
                         f"{sorted(want)}")
        for k in set(db) & want:
            d, c = db[k], clips[keys[k]]
            dz = d["trans"][:, 2] - np.asarray(c["trans"], np.float32)[:, 2]
            if not (np.array_equal(d["pose_aa"][:, :72], c["pose_aa"])
                    and d["pose_aa"].shape[1] == 156
                    and d["pose_6d"].shape == (len(c["pose_aa"]), 52, 6)
                    and np.array_equal(d["trans"][:, :2],
                                       np.asarray(c["trans"], np.float32)[
                                           :, :2])
                    and np.ptp(dz) < 1e-5
                    and np.abs(d["trans"] - cpu_trans[k]).max() < 1e-6):
                fails.append(f"process_amass {k}: not the clip's frames")
    return fails


def camfit_setup(dev, clip):
    """CameraFit on the stand-in's offsets over a gait clip's first
    CAMFIT_FRAMES frames: targets are the true pose's projection (all
    inliers); returns (fit, true input_vec, seeded start)."""
    import numpy as np
    import torch

    from uhc_tpu_torch.smpl import humanoid_batch as HB
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    _, model = load_fixture_humanoid()
    K = np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1]])
    R = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])   # +y forward, z up
    smpl2op = np.array([24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4,
                        7, 25, 26, 27, 28])
    fit = HB.CameraFit(offsets=model.body_pos, full_R=R,
                       full_t=[0.0, 1.0, CAMFIT_DEPTH], K=K, img_w=1920,
                       img_h=1080, smpl2op_map=smpl2op, device=dev)
    T = CAMFIT_FRAMES
    true = torch.as_tensor(np.concatenate(
        [clip["trans"][:T], clip["pose_aa"][:T]], 1), dtype=torch.float32,
        device=dev)
    with torch.no_grad():
        gt = fit.proj2d(HB.fk_batch(fit.offsets, true[:, 3:],
                                    true[:, :3])["wbpos"])
    fit.update_tgt_joints(gt, torch.ones_like(gt, dtype=torch.bool))
    rng = np.random.default_rng(33)
    start = true + torch.as_tensor(
        CAMFIT_NOISE * rng.standard_normal(true.shape), dtype=torch.float32,
        device=dev)
    return fit, true, start


def camfit_run(dev, clip) -> dict:
    """The four losses and their gradients at the start, and the descent
    of proj_2d_loss, on `dev` (line loss: targets of the projected subset's
    14 joints, as the loss needs)."""
    import torch

    from uhc_tpu_torch.smpl import humanoid_batch as HB

    fit, true, x0 = camfit_setup(dev, clip)
    out = {"loss": {}, "grad": {}}
    for name in ("proj_2d_loss", "proj_2d_body_loss"):
        out["loss"][name], out["grad"][name] = HB.loss_and_grad(
            getattr(fit, name), x0)
    out["loss"]["proj_2d_root_loss"], out["grad"]["proj_2d_root_loss"] = \
        HB.loss_and_grad(fit.proj_2d_root_loss, x0[0, :6])
    line = HB.CameraFit(offsets=fit.offsets, full_R=fit.full_R,
                        full_t=fit.full_t, K=fit.K, img_w=fit.img_w,
                        img_h=fit.img_h, smpl2op_map=fit.smpl2op_map,
                        device=dev)
    with torch.no_grad():
        _, cam = line.proj2d(HB.fk_batch(line.offsets, true[:, 3:],
                                         true[:, :3])["wbpos"],
                             return_cam_3d=True)
    pix = cam @ line.K.T
    pix = pix[..., :2] / pix[..., 2:]
    line.update_tgt_joints(pix, torch.ones_like(pix, dtype=torch.bool))
    out["loss"]["proj_2d_line_loss"], out["grad"]["proj_2d_line_loss"] = \
        HB.loss_and_grad(line.proj_2d_line_loss, x0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["losses"], out["grads"], out["x"] = HB.descend(
        fit.proj_2d_loss, x0, CAMFIT_LR, CAMFIT_STEPS)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / CAMFIT_STEPS
    return out


def camfit_check(card, cpu) -> tuple:
    """The card's losses and gradients against the CPU's -> (errors,
    failures)."""
    import torch

    def rel(a, b, scale):
        return float((a.cpu() - b).abs().max() / scale)

    errs, fails = {}, []
    for name in card["loss"]:
        le = rel(card["loss"][name], cpu["loss"][name],
                 cpu["loss"][name].abs())
        ge = rel(card["grad"][name], cpu["grad"][name],
                 cpu["grad"][name].abs().max())
        errs[name] = {"loss_rel": le, "grad_rel": ge}
        if not (le <= CAMFIT_LOSS_RTOL and ge <= CAMFIT_GRAD_RTOL):
            fails.append(f"camfit {name}: {errs[name]}")
    lc, lh = card["losses"].cpu(), cpu["losses"]
    errs["descent_loss_rel"] = float(((lc - lh).abs() / lh.abs()).max())
    errs["descent_grad_rel"] = max(
        rel(card["grads"][i], cpu["grads"][i],
            cpu["grads"][i].abs().max()) for i in (0, CAMFIT_STEPS - 1))
    if not (errs["descent_loss_rel"] <= CAMFIT_LOSS_RTOL
            and errs["descent_grad_rel"] <= CAMFIT_GRAD_RTOL):
        fails.append(f"camfit descent: {errs}")
    if not (bool(torch.isfinite(lc).all()) and lc[-1] < 0.5 * lc[0]
            and bool(torch.all(lc[1:] <= lc[:-1]))):
        fails.append(f"camfit: the loss did not fall: {lc.tolist()}")
    return errs, fails


def zoo_nets(gen):
    """The zoo at full width, seeded: {name: (module on the CPU, inputs on
    the CPU, forward(module, *inputs))}."""
    import torch

    from uhc_tpu_torch.learn import nets as N

    def init(m):
        return N.zoo_init(m, gen, "cpu")

    def x(*shape):
        return torch.randn(shape, generator=gen)

    img = x(ZOO_BATCH, 3, ZOO_IMAGE, ZOO_IMAGE)
    frames = x(ZOO_FRAMES, 3, ZOO_IMAGE, ZOO_IMAGE)
    feats = x(ZOO_BATCH, 128, 120)
    obs = x(256, ZOO_OBS)
    call = lambda m, *a: m(*a)  # noqa: E731
    return {
        "simple_cnn": (init(N.SimpleCNN(128)), (img,), call),
        "resnet_feat": (init(N.ResNetFeat(128)), (img,), call),
        "mobile_net": (init(N.MobileNet(128)), (img,), call),
        "video_reg_net": (init(N.VideoRegNet(72, 128, 128, "mobile", "gru",
                                              (300, 200))), (frames,), call),
        "tcn": (init(N.TCN(128, (64, 128))), (feats,), call),
        "tcn_causal": (init(N.TCN(128, (64, 128))), (feats,),
                       lambda m, a: m(a, True)),
        "erd": (init(N.ERD(72)), (x(60, 64, 72),), lambda m, a: m(a)[0]),
        "cmlp": (init(N.CMLP(ZOO_OBS, 64, (512, 256))),
                 (x(256, 64), obs), call),
        "discriminator": (init(N.Discriminator(ZOO_OBS, (512, 256))),
                          (obs,), call),
        "policy_discrete": (init(N.PolicyDiscrete(ZOO_OBS, 16, (512, 256))),
                            (obs,), lambda m, a: N.categorical_log_prob(
                                m(a), torch.argmax(m(a), -1))),
    }


def zoo_phase(dev) -> tuple:
    """Every zoo net on the card against the port on the CPU (the same
    seeded weights and inputs); forward ms on the card -> (numbers,
    failures)."""
    import copy

    import torch

    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("zoo: TF32 is on")
    numbers, fails = {}, []
    for name, (m, ins, fwd) in zoo_nets(torch.Generator().manual_seed(
            34)).items():
        with torch.no_grad():
            want = fwd(m, *ins)
            mc = copy.deepcopy(m).to(dev)
            ic = tuple(t.to(dev) for t in ins)
            got = fwd(mc, *ic)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: fwd(mc, *ic), 3)
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        numbers[name] = {"max_abs_err": float((got.cpu() - want).abs()
                                              .max()), "rel_err": err,
                         "ms": ms, "shape": list(got.shape)}
        if not (err <= ZOO_RTOL and bool(torch.isfinite(got).all())):
            fails.append(f"zoo {name}: {numbers[name]}")
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        fails.append("zoo: TF32 was switched on while the zoo ran")
    return numbers, fails


def tools_phase(topo, model, model_np, dev) -> tuple:
    """Phase tools: (a) a synthetic AMASS directory (the gait clips in
    three corpora, one per split) through `data/process_amass` on the card
    with grounding, checked against the clips and the grounding on the CPU;
    (b) `cli/eval --dump` over the train split through K1 with the seeded
    full-width copycat, then `cli/replay --list` and `--dump-states`
    (pred_jpos equal to the dump's); (c) `fk_jpos` (render_eval_result's
    FK) on the dump's qpos, card against CPU; (d) CameraFit over one gait
    clip, card against CPU; (e) the zoo; (f) `gather_windows` on the
    device library -> (numbers, failures, K1 launches)."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from uhc_tpu_torch.cli import eval as eval_cli
    from uhc_tpu_torch.cli import replay
    from uhc_tpu_torch.data import process_amass as PA
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.data.windows import WindowSampler, gather_windows
    from uhc_tpu_torch.smpl.lbs import load_smpl_data
    from uhc_tpu_torch.utils.visualizer import fk_jpos

    numbers, fails = {"rendering": "none on the card (no matplotlib, cv2 "
                      "or joblib there); tests/test_torch_viz_tools.py "
                      "renders on the CPU"}, []
    clips = load_motion_file("sample_data/gait_clips.pkl")
    with tempfile.TemporaryDirectory() as d:
        raw, keys = amass_raw(clips)
        write_amass_dir(os.path.join(d, "amass"), raw)
        smpl = stand_in_smpl_file(d)
        t0 = time.perf_counter()
        paths = PA.main(["--dir", os.path.join(d, "amass"), "--out_dir",
                         os.path.join(d, "out"), "--smpl", smpl,
                         "--device", str(dev)])
        numbers["process_amass_s"] = time.perf_counter() - t0
        cpu_db = PA.process_amass_db(PA.read_amass_dir(
            os.path.join(d, "amass")), None, load_smpl_data(smpl),
            device="cpu")
        fails += amass_check(paths, keys, clips,
                             {k: v["trans"] for k, v in cpu_db.items()})
        dump = os.path.join(d, "dump.pkl")
        reset_counts()
        res = eval_cli.main(["--motion", paths[TOOLS_EVAL_SPLIT], "--dump",
                             dump, "--seed", "0", "--device", str(dev)])
        torch.cuda.synchronize()
        steps = res["control_steps"]
        if counts() != expect(steps, "k1"):
            fails.append(f"tools eval: launches {counts()}, expected "
                         f"{steps} of K1")
        k1_launches = counts()["k1"]
        with open(dump, "rb") as f:
            dumped = pickle.load(f)
        listed = replay.main(["--data", dump, "--list"])
        key = next(iter(dumped))
        npz = os.path.join(d, "states.npz")
        replay.main(["--data", dump, "--take", key, "--dump-states", npz,
                     "--no-render"])
        states = np.load(npz)
        replay_equal = (set(listed) == set(dumped) and all(
            np.array_equal(states[f], dumped[key][f])
            for f in ("pred_jpos", "gt_jpos", "pred_qpos", "gt_qpos")))
        if not replay_equal:
            fails.append("replay: --dump-states differs from the dump")
        summary = res["summary"]
        if not all(np.isfinite(v) for v in summary.values()):
            fails.append(f"tools eval: summary {summary}")
        numbers["eval"] = {"split": TOOLS_EVAL_SPLIT, "clips": len(dumped),
                           "control_steps": steps, "k1_launches": k1_launches,
                           "ms_per_step": res["ms_per_step"],
                           "summary": summary, "replay_equal": replay_equal}

        # render_eval_result's FK, card against CPU
        q = dumped[key]["pred_qpos"]
        fk_card = fk_jpos(topo, model, q, dev)
        fk_cpu = fk_jpos(topo, model_np, q, "cpu")
        t0 = time.perf_counter()
        for _ in range(10):
            fk_jpos(topo, model, q, dev)
        fk_ms = 1e2 * (time.perf_counter() - t0)
        fk_err = float(np.abs(fk_card - fk_cpu).max())
        numbers["fk"] = {"frames": len(q), "max_abs_err": fk_err,
                         "ms": fk_ms, "tol": FK_ATOL}
        if not fk_err <= FK_ATOL:
            fails.append(f"fk_jpos: card vs CPU {fk_err}")

    # CameraFit, card against CPU
    clip = clips[CAMFIT_CLIP]
    card = camfit_run(dev, clip)
    cpu = camfit_run(torch.device("cpu"), clip)
    errs, f = camfit_check(card, cpu)
    fails += f
    numbers["camfit"] = {
        "frames": CAMFIT_FRAMES, "steps": CAMFIT_STEPS, "lr": CAMFIT_LR,
        "loss_first_last": [float(card["losses"][0]),
                            float(card["losses"][-1])],
        "losses_at_start": {k: float(v) for k, v in card["loss"].items()},
        "ms_per_step": card["ms_per_step"],
        "cpu_ms_per_step": cpu["ms_per_step"], "vs_cpu": errs,
        "tols": [CAMFIT_LOSS_RTOL, CAMFIT_GRAD_RTOL]}

    numbers["zoo"], f = zoo_phase(dev)
    fails += f

    # gather_windows over the device library, against a CPU copy
    lib, _ = build_expert_library(topo, model, clips)
    keys_w = ["qpos", "qvel", "wbpos", "wbquat"]
    seq, start = WindowSampler(lib["len"].cpu().numpy(), WINDOW,
                               seed=35).sample(WINDOW_BATCH)
    got = gather_windows(lib, keys_w, seq, start, WINDOW)
    want = gather_windows({k: lib[k].cpu() for k in keys_w}, keys_w, seq,
                          start, WINDOW)
    equal = all(torch.equal(got[k].cpu(), want[k]) for k in keys_w)
    ms = cuda_ms(lambda: gather_windows(lib, keys_w, seq, start, WINDOW), 10)
    numbers["windows"] = {"batch": WINDOW_BATCH, "window": WINDOW,
                          "equal": equal, "ms": ms,
                          "device": str(got["qpos"].device)}
    if not (equal and got["qpos"].device.type == "cuda"):
        fails.append(f"gather_windows: {numbers['windows']}")
    return numbers, fails, k1_launches


# phase data_parallel: the global run of `cli/train --data-parallel`
# (uhc_implicit at full width, 1024 envs × 48 steps, 2 epochs) as DP_RANKS
# ranks on one card over gloo (a rehearsal: the ranks' contexts time-slice
# the card), the PPO update of one fixed batch of DP_PPO (steps, envs a
# rank) over the ranks against one process, and a --profile run
DP_RANKS, DP_EPOCHS, DP_HORIZON = 2, 2, 48
DP_TRAIN_ARGS = ["--num-envs", "1024", "--horizon", str(DP_HORIZON),
                 "--no-train-eval", "--epochs", str(DP_EPOCHS)]
DP_PPO = (8, 512)
# the --profile run: envs, horizon, epochs (the trace covers epochs 2-4)
DP_PROFILE = (64, 8, 5)
DP_PROFILE_ARGS = ["--num-envs", str(DP_PROFILE[0]), "--horizon",
                   str(DP_PROFILE[1]), "--epochs", str(DP_PROFILE[2]),
                   "--no-train-eval"]
DP_TIMEOUT_S = 300.0
# (b): a net's change over the ranks against one process's, in norm
DP_MOVED = 0.1


def dp_batch(obs_dim: int, act_dim: int, world: int, shape=DP_PPO):
    """Phase data_parallel's fixed PPO batch, (T, W·B) for `shape` (T, B)
    from a seed, rows flattened time-major as the agent's: advantages
    large enough that the clip is exercised."""
    import torch

    T, B = shape
    g = torch.Generator().manual_seed(31)
    shape = (T, world * B)
    return {"states": torch.randn((*shape, obs_dim), generator=g),
            "actions": 0.3 * torch.randn((*shape, act_dim), generator=g),
            "advantages": 10.0 * torch.randn(shape, generator=g),
            "returns": 2.0 + torch.randn(shape, generator=g),
            "exps": (torch.rand(shape, generator=g) < 0.7).float()}


def dp_nets(cfg, obs_dim, act_dim, dev) -> tuple:
    """The seeded full-width (policy, value) of phase data_parallel's PPO
    update."""
    import torch

    from uhc_tpu_torch.learn import nets

    gen = torch.Generator().manual_seed(32)
    return (nets.make_policy(cfg, obs_dim, act_dim, gen, dev),
            nets.value_init(obs_dim, cfg.value_hsize, gen, cfg.value_htype,
                            dev))


def dp_ppo(cfg, obs_dim, act_dim, dev, dist=None, shape=DP_PPO) -> tuple:
    """One PPO update (2 passes, minibatch half the global batch) of
    seeded full-width nets on phase data_parallel's batch: ppo_update over
    the whole batch, or ppo_update_dist on this rank's envs; the shuffle
    generator on the card, seeded 0 -> (policy, value numpy, stats)."""
    import torch

    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.ppo import ppo_update, ppo_update_dist

    T, B = shape
    batch = dp_batch(obs_dim, act_dim, DP_RANKS, shape)
    if dist is not None:
        cols = slice(dist.rank * B, (dist.rank + 1) * B)
        batch = {k: v[:, cols] for k, v in batch.items()}
    batch = {k: v.reshape(-1, *v.shape[2:]).contiguous().to(dev)
             for k, v in batch.items()}
    policy, value = dp_nets(cfg, obs_dim, act_dim, dev)
    log_std = torch.full((act_dim,), cfg.log_std, device=dev)
    popt = torch.optim.Adam(policy.parameters(), lr=cfg.policy_lr)
    vopt = torch.optim.Adam(value.parameters(), lr=cfg.value_lr)
    shuffle = torch.Generator(device=dev).manual_seed(0)
    mb = T * B * DP_RANKS // 2
    if dist is None:
        stats = ppo_update(policy, value, popt, vopt, log_std, batch,
                           shuffle, cfg.clip_epsilon, 2, mb)
    else:
        stats = ppo_update_dist(policy, value, popt, vopt, log_std, batch,
                                shuffle, cfg.clip_epsilon, 2, mb, dist, B)
    return (nets.policy_to_numpy(policy), nets.value_to_numpy(value),
            {k: float(v) for k, v in stats.items()})


def dp_rank(d, out: str, train_args, ppo_shape) -> dict:
    """One rank of phase data_parallel's rehearsal: `cli/train
    --data-parallel`'s run of `train_args` (cli/train.run as this rank),
    its launches, its policy's mean on a seeded probe, then the
    fixed-batch PPO update of `ppo_shape`."""
    import hashlib

    import numpy as np
    import torch

    from uhc_tpu_torch.cli import train

    args = train.parser().parse_args(train_args + ["--results-dir", out])
    reset_counts()
    agent, hist = train.run(args, d.device, d)
    got = counts()
    probe = torch.randn((64, agent.obs_dim),
                        generator=torch.Generator().manual_seed(5)).to(
        d.device)
    with torch.no_grad():
        mean = agent.policy(probe).cpu().numpy()
    c0 = d.seconds
    pol, val, ppo_stats = dp_ppo(agent.cfg, agent.obs_dim, agent.action_dim,
                                 d.device, d, ppo_shape)
    h = hashlib.sha256()
    for leaf in _flat([pol, val]):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return {"launches": got, "history": hist,
            "digests": agent.replica_digests, "mean": mean,
            "ppo": (pol, val, ppo_stats) if d.rank == 0 else None,
            "ppo_digest": h.hexdigest(), "ppo_collective_s": d.seconds - c0,
            "env_steps": agent.local_envs * agent.horizon}


def dp_check_run(name, results, out, want_k1, dev) -> tuple:
    """The checks of a data-parallel run's ranks: K1 launches `want_k1` on
    every rank and no other kernel, every epoch's replica digest the same
    on every rank, finite stats, the value loss falling, and rank 0's
    checkpoint loaded in a single-process agent on the card with the
    ranks' digest -> (the loaded agent, failures)."""
    import numpy as np

    from uhc_tpu_torch.learn.agent import CopycatAgent
    from uhc_tpu_torch.config.config import Config

    fails = []
    for r, res in enumerate(results):
        if res["launches"] != want_k1:
            fails.append(f"{name}: rank {r} launched {res['launches']}, "
                         f"expected {want_k1}")
        if res["digests"] != results[0]["digests"] or \
                len(res["digests"]) != DP_EPOCHS:
            fails.append(f"{name}: rank {r}'s digests {res['digests']} "
                         f"against rank 0's {results[0]['digests']}")
        for i, st in enumerate(res["history"]):
            if not all(np.all(np.isfinite(v)) for v in st.values()):
                fails.append(f"{name}: rank {r} epoch {i} stats not "
                             f"finite: {st}")
            if not st["value_loss"] < st["value_loss_before"]:
                fails.append(f"{name}: rank {r} epoch {i}: value loss did "
                             f"not fall")
    agent = CopycatAgent(Config.uhc_implicit(), "sample_data/gait_clips.pkl",
                         num_envs=64, horizon=8, results_dir=out,
                         device=dev)
    agent.load_checkpoint(DP_EPOCHS)
    if agent.replica_digest() != results[0]["digests"][-1]:
        fails.append(f"{name}: rank 0's checkpoint loads to another digest "
                     f"than the ranks'")
    return agent, fails


def dp_rates(results) -> list:
    """Each rank's per-epoch rollout env-steps/s (its own envs), PPO ms
    and collective ms."""
    return [{"rollout_env_steps_per_s": [st["rank_rollout_steps_per_sec"]
                                         for st in r["history"]],
             "ppo_update_ms": [1e3 * st["T_update"] for st in r["history"]],
             "collectives_ms": [1e3 * st["T_collectives"]
                                for st in r["history"]],
             "epoch_s": [st["T_total"] for st in r["history"]]}
            for r in results]


def dp_rehearsal(dev, backend: str = "gloo") -> tuple:
    """Phase data_parallel's (a) and (b): DP_RANKS ranks of `cli/train
    --data-parallel`'s run on `dev` over `backend` (checks in
    dp_check_run; rank 0's checkpoint's policy mean equal to the ranks'),
    then the fixed-batch PPO update over the ranks against ppo_update on
    one process with the same permutations: params within 2·lr per Adam
    step, losses within 1e-5 relative (tests/test_torch_train.py's
    bounds), each net's change within DP_MOVED of the one process's
    change in norm (Adam hides a gradient's scale, not its direction; a
    few steps that flip sign stay well inside), the ranks' results bit
    for bit alike -> (numbers, failures, K1 launches)."""
    import tempfile

    import numpy as np
    import torch

    from uhc_tpu_torch.learn import data_parallel as DP, nets

    numbers = {"backend": backend, "ranks": DP_RANKS}
    steps = DP_EPOCHS * DP_HORIZON
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        # every rank on this one device ("cuda" alone is a card a rank)
        shared = (f"cuda:{torch.cuda.current_device()}"
                  if dev.type == "cuda" and dev.index is None else str(dev))
        res = DP.spawn(dp_rank, DP_RANKS, shared, backend,
                       args=(out, DP_TRAIN_ARGS, DP_PPO),
                       wait=DP_TIMEOUT_S)
        numbers["seconds"] = time.perf_counter() - t0
        agent, fails = dp_check_run("rehearsal", res, out,
                                    expect(steps, "k1"), dev)
        probe = torch.randn((64, agent.obs_dim),
                            generator=torch.Generator().manual_seed(5)).to(
            dev)
        with torch.no_grad():
            if not np.array_equal(agent.policy(probe).cpu().numpy(),
                                  res[0]["mean"]):
                fails.append("rehearsal: the checkpoint's policy mean is not "
                             "the ranks'")
    numbers["launches"] = [r["launches"]["k1"] for r in res]
    numbers["rank"] = dp_rates(res)
    numbers["reward_mean"] = [st["reward_mean"] for st in res[0]["history"]]
    numbers["digests"] = res[0]["digests"]
    # (b) the fixed batch: the ranks' update against one process's
    pol, val, stats = res[0]["ppo"]
    spol, sval, sstats = dp_ppo(agent.cfg, agent.obs_dim, agent.action_dim,
                                dev, shape=DP_PPO)
    pol0, val0 = dp_nets(agent.cfg, agent.obs_dim, agent.action_dim, dev)
    pol0, val0 = nets.policy_to_numpy(pol0), nets.value_to_numpy(val0)
    errs = {}
    adam_steps = 2 * 2          # 2 passes × 2 minibatches
    for tag, a, b, a0, lr in (
            ("policy", spol, pol, pol0, agent.cfg.policy_lr),
            ("value", sval, val, val0, agent.cfg.value_lr)):
        errs[tag] = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                        for x, y in zip(_flat(a), _flat(b)))
        if errs[tag] > 2 * lr * adam_steps:
            fails.append(f"ppo: {tag} params {errs[tag]} from one "
                         f"process's, over 2·lr per Adam step")
        moved = [np.concatenate([(np.asarray(x, np.float64) - y).ravel()
                                 for x, y in zip(_flat(t), _flat(a0))])
                 for t in (a, b)]
        errs[f"{tag}_moved"] = float(np.linalg.norm(moved[1] - moved[0])
                                     / np.linalg.norm(moved[0]))
        if errs[f"{tag}_moved"] > DP_MOVED:
            fails.append(f"ppo: {tag}'s change {errs[f'{tag}_moved']} "
                         f"from one process's in norm, over {DP_MOVED}")
    for k in ("value_loss_before", "value_loss", "policy_loss"):
        errs[k] = abs(stats[k] - sstats[k]) / max(abs(sstats[k]), 1e-30)
        if errs[k] > 1e-5:
            fails.append(f"ppo: {k} {stats[k]} against {sstats[k]}")
    if len({r["ppo_digest"] for r in res}) != 1:
        fails.append("ppo: the ranks' updated params differ")
    numbers["ppo_vs_one_process"] = errs
    numbers["ppo_collectives_ms"] = [1e3 * r["ppo_collective_s"]
                                     for r in res]
    return numbers, fails, sum(numbers["launches"])


def dp_multi_card(dev) -> tuple:
    """Phase data_parallel's (c): `cli/train --data-parallel` itself, a
    card a rank over NCCL on every visible card, with dp_check_run's
    checks -> (numbers, failures, K1 launches)."""
    import tempfile

    import torch

    from uhc_tpu_torch.cli import train

    steps = DP_EPOCHS * DP_HORIZON
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        _, res = train.main(["--data-parallel"] + DP_TRAIN_ARGS
                            + ["--results-dir", out])
        seconds = time.perf_counter() - t0
        for r in res:           # control_step.LAUNCHES of each rank
            r["launches"] = {k: v for k, v in r["launches"].items() if v}
        _, fails = dp_check_run("multi_card", res, out,
                                {("step", 24, False): steps}, dev)
    launches = [r["launches"].get(("step", 24, False), 0) for r in res]
    return {"ran": True, "cards": torch.cuda.device_count(),
            "seconds": seconds, "launches": launches,
            "rank": dp_rates(res)}, fails, sum(launches)


def dp_profile(dev) -> tuple:
    """Phase data_parallel's (d): `cli/train --profile` at DP_PROFILE_ARGS:
    K1 once a control step and the trace's epoch spans 2 to 4 and
    control_step_kernel -> (numbers, failures, K1 launches)."""
    import re
    import tempfile

    from uhc_tpu_torch.cli import train

    fails = []
    with tempfile.TemporaryDirectory() as out:
        prof = os.path.join(out, "prof")
        reset_counts()
        t0 = time.perf_counter()
        train.main(DP_PROFILE_ARGS + ["--results-dir", out, "--profile", prof]
                   + ([] if dev.type == "cuda" else ["--device", "cpu"]))
        seconds = time.perf_counter() - t0
        got = counts()
        if got != expect(DP_PROFILE[1] * DP_PROFILE[2], "k1"):
            fails.append(f"profile: launches {got}")
        path = os.path.join(prof, "trace.json")
        with open(path) as fh:
            text = fh.read()
    spans = sorted(set(re.findall(r'"name": "uhc\.(epoch \d+)"', text)))
    kernel = "control_step_kernel" in text
    if spans != ["epoch 2", "epoch 3", "epoch 4"]:
        fails.append(f"profile: spans {spans}")
    if not kernel:
        fails.append("profile: the trace names no control_step_kernel")
    return {"seconds": seconds, "spans": spans,
            "names_control_step_kernel": kernel, "trace_bytes": len(text),
            "launches": got["k1"]}, fails, got["k1"]


def data_parallel_phase(dev) -> tuple:
    """Phase data_parallel: (a) and (b) `dp_rehearsal` on the card over
    gloo, (c) `dp_multi_card` where there are two cards or more, (d)
    `dp_profile` -> (numbers, failures, K1 launches)."""
    import torch

    numbers, fails, k1 = dp_rehearsal(dev)
    numbers = {"rehearsal": numbers,
               "multi_card": {"ran": False,
                              "cards": torch.cuda.device_count()}}
    if torch.cuda.device_count() >= 2:
        numbers["multi_card"], f, n = dp_multi_card(dev)
        fails, k1 = fails + f, k1 + n
    numbers["profile"], f, n = dp_profile(dev)
    return numbers, fails + f, k1 + n


def run(parent=None) -> int:
    """Every phase; `parent` is --parent's source, or None."""
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
    from uhc_tpu_torch.device import card_line

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = card_line()
    done("device", card=card, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         python=sys.version.split()[0], count=torch.cuda.device_count())

    phase("build", "(nvcc, sm_90a; 22, 24, 48, 52 and 55 bodies and 32 "
                   "bodies built and sized only, one nvcc each, at once)")
    from uhc_tpu_torch.csrc import build

    t0 = time.perf_counter()
    big_nb = tuple(nb for _, nb in BIG)
    with ThreadPoolExecutor(1) as pool:
        # the --parent build's nvcc run beside this checkout's
        parent_build = (pool.submit(build.build_libraries, (24, *big_nb),
                                    parent) if parent else None)
        libs = build.build_libraries((TOE_BODIES, *BODIES,
                                      *COMPILE_ONLY_BODIES))
        parent_libs = parent_build.result() if parent else None
    lib_cuda = libs[24]

    def ptxas(key):
        key = ("cuda", key) if isinstance(key, int) else key
        return [ln.strip() for ln in build.build_log.get(
            key, {}).get("stderr", "").splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]

    # the 24-body layout on the SMPL tree: J6 and G by subtree, two blocks
    # of every kernel per SM
    from uhc_tpu_torch.physics.control_step import jacobian_tables
    from uhc_tpu_torch.physics.model import Topology
    from uhc_tpu_torch.smpl.constants import MUJOCO_PARENTS

    jg_smpl = int(jacobian_tables(Topology(
        24, tuple(MUJOCO_PARENTS.tolist()), ("",) * 24))[0][-1])
    occ24 = build.occupancy(lib_cuda, jg_smpl)
    # the small trees: remove_toe's 22 bodies on its own J6 / G, and the
    # 32-body build at a chain's J6 / G, the most a 32-body tree needs
    from uhc_tpu_torch.physics.control_step import max_jacobian_pairs
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid
    from uhc_tpu_torch.smpl.local_robot import remove_toe_model

    jg_small = {TOE_BODIES: int(jacobian_tables(remove_toe_model(
        *load_fixture_humanoid())[0])[0][-1]),
        **{nb: 6 * max_jacobian_pairs(nb) for nb in COMPILE_ONLY_BODIES}}
    small = {nb: {"layout": build.layout(libs[nb]), "ptxas": ptxas(nb),
                  "jg_floats": jg,
                  "occupancy": build.occupancy(libs[nb], jg),
                  "seconds": build.build_log.get(("cuda", nb), {}).get(
                      "seconds")} for nb, jg in jg_small.items()}
    done("build", seconds=time.perf_counter() - t0,
         layout=build.layout(lib_cuda), ptxas=ptxas(24),
         jg_floats=jg_smpl, occupancy=occ24, small=small,
         big={nb: {"layout": build.layout(libs[nb]), "ptxas": ptxas(nb),
                   "occupancy": build.occupancy(libs[nb]),
                   "seconds": build.build_log.get(("cuda", nb), {}).get(
                       "seconds")} for nb in BODIES[1:]},
         parent=None if parent_libs is None else {
             "source": parent,
             **{nb: {"layout": build.layout(parent_libs[nb]), "ptxas":
                     ptxas(build.library_key("cuda", nb, parent))}
                for nb in (24, *big_nb)}})
    # two blocks per SM at 24 and 22 bodies, one at least at 32
    for nb, occ, least in ((24, occ24, 2),
                           *((n, small[n]["occupancy"],
                              2 if n == TOE_BODIES else 1) for n in small)):
        few = {e: o["blocks_per_sm"] for e, o in occ.items()
               if o["blocks_per_sm"] < least}
        if few:
            raise RuntimeError(f"{nb} bodies: fewer than {least} blocks per "
                               f"SM: {few}")

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

    phase("k2_vs_plain", f"(B={B_CHECK}, the same draws, schedule (2, 2); "
                         "the head's state by gate)")
    k2_err = {"head": 0.0, "tail": 0.0}
    errs2 = {}
    head_fails = []
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
        qh32, vh32, _ = K2.head_reference(topo, env_cfg, model, qpos, qvel,
                                          act, tb, 1.0, 2)
        head_gate, fails = gate(f"K2 head {mode}", (qh, vh), (qh32, vh32),
                                (qh64, vh64))
        head_fails += fails
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
            "head": head_gate, "split_equals_k1": True}
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
    if head_fails:
        raise RuntimeError("; ".join(head_fails))

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
            qh32, vh32, _ = K2.head_reference(
                topo, env_cfg, emodel, qpos, qvel, act, tb, 1.0, 2, seq)
            e2, fails = gate(f"K2 over the library {mode}", (q2, v2),
                             plain32, plain64)
            eh, fh = gate(f"K2 head over the library {mode}", (qh, vh),
                          (qh32, vh32), (qh64, vh64))
            k1e_fails += fails + fh
            e2.update(head_vs_plain64=[(qh.double() - qh64).abs().max()
                                       .item(), (vh.double() - vh64).abs()
                                       .max().item()], head=eh,
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
                    f"big trees vs K1d at (2, 2); the heads on B={B_HEAD} "
                    "draws: their state held by gate_big, their Xp/Xf by "
                    "x_check)")
    k2_big, k2_big_fails = {}, []
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
        k2_big[f"{fam}_{mode}"] = {"split_equals_k1d": True}
    for fam, mode, btopo, benv, bmodel, ins in k1d_draws(dev, B_HEAD):
        split = K2.ControlStepSplit(btopo, benv, bmodel, 2)
        reset_counts()
        qh, vh, X = split.head(*ins, 1.0)
        if counts() != expect(1, f"k2big_head_{fam}"):
            raise RuntimeError(f"K2 head {fam} {mode}: launches {counts()}")
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (qh, vh, X)):
            raise RuntimeError(f"K2 head {fam} {mode}: output not finite")
        h32, (qh64, vh64, X64) = head_references(btopo, benv, bmodel, ins)

        def moved_head(e, btopo=btopo, benv=benv, bmodel=bmodel, ins=ins):
            return [moved_steps(btopo, benv, bmodel, ins, e, dt, stop=1)
                    for dt in (torch.float64, torch.float32)]

        eh, fh = gate_big(f"K2 head {fam} {mode}", (qh, vh), h32[:2],
                          (qh64, vh64), moved_head)
        k2_big_fails += fh
        k2_big[f"{fam}_{mode}"].update({
            "head_vs_plain64": [(qh.double() - qh64).abs().max().item(),
                                (vh.double() - vh64).abs().max().item()],
            "head": eh,
            **x_check(f"K2 {fam} {mode}", X, h32[2], X64, k2_big_fails)})
        k2_err[f"head_{fam}"] = max(k2_err.get(f"head_{fam}", 0.0),
                                    *k2_big[f"{fam}_{mode}"][
                                        "head_vs_plain64"])
        del h32, qh64, vh64, X64, X
    done("k2_big", **k2_big, x_rel_tol=X_REL_TOL)
    if k2_big_fails:
        raise RuntimeError("; ".join(k2_big_fails))

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

    phase("k2_smplx", f"(B={B_CHECK}, K2 head + tail on the 55-body SMPL-X "
                      "at PCG-2, plain PD and meta-PD, vs its plain versions "
                      "and the 55-body K1 build)")
    smplx = list(smplx_draws(dev))
    k2x_errs, k2x_fails = k2_smplx_check(smplx)
    done("k2_smplx", **k2x_errs, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL,
         x_rel_tol=X_REL_TOL)
    if k2x_fails:
        raise RuntimeError("; ".join(k2x_fails))

    phase("k2b", f"(B={B_CHECK}, K2b at PCG-2 on the draws of "
                 "kernel_vs_plain (24 bodies), k1d_vs_plain (SMPL-H) and "
                 "k2_smplx, plain PD and meta-PD)")
    k2b_errs, k2b_fails = {}, []
    k2b_cases = (
        [("smpl", mode, topo, env_cfg, model, (qpos, qvel, act, tb))
         for mode, (env_cfg, qpos, qvel, act, tb) in draws.items()]
        + [("smplh", mode, *big_draws["smplh", mode][:3],
            tuple(big_draws["smplh", mode][3:]))
           for mode in ("plain_pd", "meta_pd")]
        + [("smplx", mode, xtopo, xenv, xmodel, xins)
           for mode, xtopo, xenv, xmodel, xins in smplx])
    for tree, mode, btopo, benv, bmodel, ins in k2b_cases:
        k2b_errs[f"{tree}_{mode}"], fails = k2b_check(tree, btopo, benv,
                                                      bmodel, ins)
        k2b_fails += fails
    done("k2b", **k2b_errs, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL,
         pcg8_qpos_tol=SCHED_QPOS_TOL, pcg8_qvel_tol=SCHED_QVEL_TOL,
         x_rel_tol=X_REL_TOL)
    if k2b_fails:
        raise RuntimeError("; ".join(k2b_fails))

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
    # train_lane: 2 epochs (3 before the tools phase came), train_split 1
    # (2 before the data_parallel phase came): the whole run's time on a
    # slow host
    for train_phase, lane, epochs in (("train_lane", None, 2),
                                      ("train_split", "0", 1)):
        phase(train_phase, f"(cli/train, 1024 envs × 48 steps, {epochs} "
                           f"epochs, UHC_TPU_LANE={lane or 'unset'})")
        train_counts[train_phase] = run_train(lane, epochs, train_phase, dev)
    for train_phase, lane, epochs, args in (
            # 2 epochs (3 before the data_parallel phase came)
            ("train_shape", None, 2, SHAPE_TRAIN_ARGS),
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
    # train_smplh_explicit: 1 epoch (2 before the data_parallel phase came)
    for train_phase, name, epochs, lane_big in (
            ("train_smplh_explicit", "explicit", 1, None),
            ("train_smplh_meta_joint", "meta_joint", 1, None),
            ("train_smplh_explicit_plain", "explicit", 1, "0")):
        args = ["--cfg", name] + SMPLH_TRAIN_ARGS + (
            [] if train_phase == "train_smplh_explicit"
            else ["--no-train-eval"]) + (
            # the plain chain's epoch (no kernel) at half the horizon: the
            # run's time on a slow host
            ["--horizon", "16"] if lane_big else [])
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

    # the fit-and-eval protocol, the trainable log-std, TRPO, the obs and
    # reward families and the transformer actor
    import tempfile

    with tempfile.TemporaryDirectory() as proto_dir:
        phase("eval_singles", f"(cli/eval --results-dir {DYN19} --epoch "
                              f"{DYN19_EPOCH} --singles-dir: the 19 clips of "
                              f"{GAIT_EXT}, full length, K1)")
        singles = eval_singles(dev, proto_dir)
        done("eval_singles", **{k: v for k, v in singles.items()
                                if k != "dump"})
        phase("eval_imitation", "(cli/eval_imitation on eval_singles' dump)")
        from uhc_tpu_torch.cli import eval_imitation

        rescored = eval_imitation.main(["--results", singles["dump"]])
        if rescored["summary"] != singles["summary"]:
            raise RuntimeError(f"eval_imitation: {rescored['summary']} != "
                               f"the eval's {singles['summary']}")
        done("eval_imitation", summary_equal=True,
             num_seqs=rescored["summary"]["num_seqs"])
        phase("fit", f"(cli/fit --key {FIT_KEY}, warm start from a copy of "
                     f"iter_{DYN19_EPOCH:04d}.p, 1 epoch of 512 × 48, then "
                     "1 epoch and the full-sequence eval, K1)")
        fit_numbers = fit_phase(dev, os.path.join(proto_dir, "fit"))
        done("fit", **fit_numbers)
    phase("train_fix_std", "(uhc_implicit with fix_std=False, 1 epoch of "
                           "1024 × 48 through K1)")
    fix_std_counts, log_std_move, fix_std_agent, fix_std_batch = \
        train_fix_std(dev)
    done("train_fix_std_log_std", moved=log_std_move)
    phase("trpo", "(one TRPO update on train_fix_std's batch)")
    trpo_numbers = trpo_phase(fix_std_agent, fix_std_batch)
    del fix_std_agent, fix_std_batch
    done("trpo", **trpo_numbers)
    phase("obs_families", "(obs v0, v3, v4, v5, v6 with the new rewards, 1 "
                          f"epoch each at 1024 × {OBS_HORIZON}; the "
                          "transformer actor on the v4 tokens)")
    family_counts, family_numbers = obs_families(dev)
    done("obs_families", **family_numbers, card=smi)
    protocol_k1 = (singles["launches"] + fit_numbers["launches"]
                   + fix_std_counts["k1"]
                   + sum(c["k1"] for c in family_counts.values()))
    protocol_k1f = sum(c["k1f"] for c in family_counts.values())

    phase("rollout_smplx", "(make_env_step_batched on the 55-body SMPL-X "
                           "through learn/rollout.py, "
                           f"{SMPLX_ROLLOUT[0]} envs × {SMPLX_ROLLOUT[1]} "
                           "steps, seeded MCP policy: K2 at PCG-2)")
    rollout_x = rollout_smplx(dev)
    done("rollout_smplx", **rollout_x)

    # this slice: model data and exact shapes on the kernels of earlier
    # slices, and the ball family on its torque route
    with tempfile.TemporaryDirectory() as data_dir:
        phase("smplh_data", "(cli/train --robot-model smplh --smpl-data "
                            "<seeded 52-joint npz>, 512 envs × 32 steps, 1 "
                            "epoch through K1d on the data-built model; "
                            f"K1d there vs its plain versions by gate_big, "
                            f"B={B_CHECK})")
        train_counts["smplh_data"], smplh_data_errs, fails = \
            smplh_data_phase(dev, data_dir)
        done("smplh_data", **smplh_data_errs, launches=train_counts[
            "smplh_data"], qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL)
        if fails:
            raise RuntimeError("; ".join(fails))
        phase("smplx_data", "(make_env_step_batched on smplx_model_from_data "
                            "of a seeded 55-joint npz, "
                            f"{SMPLX_ROLLOUT[0]} envs × {SMPLX_ROLLOUT[1]} "
                            "steps through K2-55; K2-55 there vs its plain "
                            f"versions, B={B_CHECK})")
        data55 = model_data_file(data_dir, 55)
        rollout_xd = rollout_smplx(dev, data=data55)
        xd_errs, fails = k2_smplx_check(list(smplx_draws(dev, data55, 27)))
        done("smplx_data", rollout=rollout_xd, **xd_errs, qpos_tol=QPOS_TOL,
             qvel_tol=QVEL_TOL, x_rel_tol=X_REL_TOL)
        if fails:
            raise RuntimeError("; ".join(fails))
    phase("exact_shape", "(uhc_implicit_shape over the 8 shape clips on an "
                         "exact-mass library: K1e vs its plain versions by "
                         f"gate, B={B_CHECK}; the eval of the 8 clips through "
                         "K1e)")
    exact_counts, exact_numbers, fails = exact_shape_phase(topo, model, dev)
    done("exact_shape", **exact_numbers, launches=exact_counts,
         qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL)
    if fails:
        raise RuntimeError("; ".join(fails))
    phase("ball", f"(--cfg ball: cli/train 1024 envs × "
                  f"{BALL_HORIZON} steps, "
                  f"{BALL_EPOCHS} epoch(s), "
                  f"and the six-clip eval over {BALL_EVAL_FRAMES} frames on "
                  "the torque route, no kernel; "
                  f"the card's step vs its plain versions by gate, "
                  f"B={B_CHECK}; timed at B={B_BALL_TIME})")
    ball_numbers, fails = ball_phase(topo, model_np, dev)
    done("ball", **ball_numbers, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL,
         card=smi)
    if fails:
        raise RuntimeError("; ".join(fails))

    # this slice: the robot variants, remove_toe's 22-body tree through
    # the -DNB=22 build of every kernel
    phase("remove_toe", f"(the stand-in's 22-body remove_toe tree: K1-22, "
                        f"K2-22 head and tail, K1e-22, K1f-22 vs their plain "
                        f"versions by gate, B={B_CHECK}; the env's rollout of "
                        f"{SMPLX_ROLLOUT[0]} envs × {SMPLX_ROLLOUT[1]} steps "
                        f"through each; timed at B={B_TIME}; K1 on the "
                        "capsule and box_feet variants by gate)")
    ttopo, tmodel, tlib, tdiffw = remove_toe_tree(dev)
    toe_errs, fails = remove_toe_check(ttopo, tmodel, tlib, dev)
    var_errs, vfails = variant_check(topo, model, lib, dev)
    toe_roll = toe_rollouts(ttopo, tmodel, tlib, tdiffw, dev)
    toe_t = toe_times(ttopo, tmodel, tlib, dev)
    done("remove_toe", **toe_errs, variants=var_errs, rollouts=toe_roll,
         times=toe_t, bodies=ttopo.nbody, nq=ttopo.nq, nv=ttopo.nv,
         qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL, x_rel_tol=X_REL_TOL,
         card=smi)
    if fails or vfails:
        raise RuntimeError("; ".join(fails + vfails))

    # this slice: the native mesh toolkit, the kinematic-policy stack and
    # scene objects
    phase("meshtools", "(g++ build of uhc_tpu_torch/native/meshtools.cpp; "
                       "the stand-in's meshes read and weighed both ways)")
    done("meshtools", **meshtools_phase(), card=smi)
    phase("uhm", f"(one kin_env_step at B={B_CHECK} vs its plain versions "
                 "by gate; cli/train " + " ".join(UHM_TRAIN_ARGS)
          + f", {UHM_EPOCHS} epochs; cli/eval_relive of its checkpoint "
          f"over {UHM_EVAL_FRAMES} frames; the exact chain, no kernel)")
    uhm_numbers, fails = uhm_phase(dev)
    done("uhm", **uhm_numbers, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL,
         card=smi)
    if fails:
        raise RuntimeError("; ".join(fails))
    phase("objects", f"(learn/rollout.py {OBJ_ROLLOUT[0]} envs × "
                     f"{OBJ_ROLLOUT[1]} steps over a library with an object "
                     f"track through K1; K1 on its states by gate, "
                     f"B={B_CHECK}; a dynamic box on the exact chain by "
                     "gate, box dofs held, an edge env on neither side "
                     "passing only by a witness; a box drop)")
    obj_numbers, fails, obj_k1 = objects_phase(topo, model, model_np, dev)
    done("objects", **obj_numbers, qpos_tol=QPOS_TOL, qvel_tol=QVEL_TOL,
         card=smi)
    if fails:
        raise RuntimeError("; ".join(fails))

    # this slice: the data-preparation and inspection tools and the zoo
    phase("tools", f"(a synthetic AMASS directory of the gait clips in "
                   f"{', '.join(AMASS_CORPORA)} through data/process_amass "
                   f"with grounding; cli/eval --dump over its "
                   f"{TOOLS_EVAL_SPLIT} split through K1, cli/replay --list "
                   f"and --dump-states; render_eval_result's FK; CameraFit "
                   f"over {CAMFIT_FRAMES} frames, {CAMFIT_STEPS} steps; the "
                   f"zoo at {ZOO_IMAGE}×{ZOO_IMAGE}; gather_windows; each "
                   "against the port on the CPU; no rendering on the card)")
    tools_numbers, fails, tools_k1 = tools_phase(topo, model, model_np, dev)
    done("tools", **tools_numbers, card=smi)
    if fails:
        raise RuntimeError("; ".join(fails))

    # this slice: data-parallel training and --profile
    phase("data_parallel", f"((a) cli/train --data-parallel's run as "
                           f"{DP_RANKS} ranks on cuda:0 over gloo, "
                           f"uhc_implicit {' '.join(DP_TRAIN_ARGS)}; (b) "
                           f"one PPO update of a fixed {DP_PPO[0]} × "
                           f"{DP_RANKS}·{DP_PPO[1]} batch over the ranks vs "
                           f"one process; (c) cli/train --data-parallel over "
                           f"NCCL on {torch.cuda.device_count()} card(s), "
                           + ("run" if torch.cuda.device_count() >= 2
                              else "not run: one card")
          + f"; (d) --profile {' '.join(DP_PROFILE_ARGS)})")
    dp_numbers, fails, dp_k1 = data_parallel_phase(dev)
    done("data_parallel", **dp_numbers, card=smi)
    if fails:
        raise RuntimeError("; ".join(fails))

    phase("kernel_bench", "(python -m uhc_tpu_torch.cli.kernel_bench, "
                          "B=2048, STEPS=20: " + " ".join(KERNEL_BENCH_ROWS)
          + ")")
    from uhc_tpu_torch.cli import kernel_bench

    os.environ["B"], os.environ["STEPS"] = "2048", "20"
    reset_counts()
    try:
        bench_lines = kernel_bench.main(list(KERNEL_BENCH_ROWS))
    finally:
        os.environ.pop("B", None)
        os.environ.pop("STEPS", None)
    bench_counts = counts()
    for row, line in zip(KERNEL_BENCH_ROWS, bench_lines):
        c = kernel_bench.parse_cfg(row)
        nb = dict(K2B_TREES)[c["MODEL"]]
        bf = "_bf16" if c["BF16"] and not c["LANE"] else ""
        parts = ("head", "tail") if c["SPLIT"] and not c["LANE"] else (
            "step",)
        want = {f"{e}{bf}/{nb}": 20 for e in parts}
        if line["launches"] != want or not line["substeps_per_sec"] > 0 \
                or set(line["no_effect_on_card"]) != set(
                    kernel_bench.NO_EFFECT_ON_CARD):
            raise RuntimeError(f"kernel_bench {row}: {line}")
    ms = {row: line["ms_per_ctrl_step"]
          for row, line in zip(KERNEL_BENCH_ROWS, bench_lines)}
    done("kernel_bench", launches=bench_counts, rows=len(bench_lines),
         ms_per_ctrl_step=ms, k2b_over_k2={
             "smpl": ms["SPLIT=1,PCG=2,BF16=1"] / ms["SPLIT=1,PCG=2"],
             "smplh": (ms["SPLIT=1,PCG=2,BF16=1,MODEL=smplh"]
                       / ms["SPLIT=1,PCG=2,MODEL=smplh"])})

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
    def k2_bounds(x_bytes):
        out = {}
        for part, active, start in (("head", trace2[:1], 0),
                                    ("tail", trace2[1:], 1)):
            fl = CS.control_step_flops(topo, cfg.env, active, (2, 2), start)
            by = 4 * state_io + x_bytes
            t_op, t_by = fl / H100_F32_FLOPS, by / H100_BYTES_PER_S
            out[part] = {"flops": fl, "bytes": by,
                         "bound_ms": 1e3 * max(t_op, t_by),
                         "bound_by": "operations" if t_op >= t_by
                         else "bytes"}
        return out

    k2_bound = k2_bounds(4 * X.numel())
    # K2b at the same inputs after K2: head and tail apart (its Xp/Xf
    # move as bfloat16), and its one-launch form, K1 with the flag at
    # (2, 2)
    k2b = K2.ControlStepSplit(topo, cfg.env, model, 2, precond_bf16=True)
    k1b = CS.ControlStep(topo, cfg.env, model, (2, 2), precond_bf16=True)
    qhb, vhb, Xb = k2b.head(qpos, qvel, act, tb, 1.0)
    k2b.tail(qhb, vhb, act, tb, Xb, 1.0)
    k1b(qpos, qvel, act, tb, 1.0)
    torch.cuda.synchronize()
    k2b_t = {
        "head_ms": cuda_ms(lambda: k2b.head(qpos, qvel, act, tb, 1.0), 10),
        "tail_ms": cuda_ms(lambda: k2b.tail(qhb, vhb, act, tb, Xb, 1.0), 10),
        "k1_bf16_ms": cuda_ms(lambda: k1b(qpos, qvel, act, tb, 1.0), 10),
        "plain_head_ms": cuda_ms(lambda: K2.head_reference(
            topo, cfg.env, model, qpos, qvel, act, tb, 1.0, 2,
            precond_bf16=True), 2),
        "plain_tail_ms": cuda_ms(lambda: K2.tail_reference(
            topo, cfg.env, model, qhb, vhb, act, tb, Xb, 1.0, 2,
            precond_bf16=True), 2),
        "k1_bf16_plain_ms": cuda_ms(lambda: CS.control_step_reference(
            topo, cfg.env, model, qpos, qvel, act, tb, 1.0, (2, 2),
            precond_bf16=True), 2),
        "x_bytes": Xb.numel() * Xb.element_size(),
        "bound": k2_bounds(Xb.numel() * Xb.element_size())}
    k2b_t["over_k2"] = ((k2b_t["head_ms"] + k2b_t["tail_ms"])
                        / (head_ms + tail_ms))
    fl22 = CS.control_step_flops(topo, cfg.env, trace2, (2, 2))
    k2b_t["k1_bf16_bound"] = {
        "flops": fl22, "bytes": 4 * state_io,
        "bound_ms": 1e3 * max(fl22 / H100_F32_FLOPS,
                              4 * state_io / H100_BYTES_PER_S),
        "bound_by": ("operations" if fl22 / H100_F32_FLOPS
                     >= 4 * state_io / H100_BYTES_PER_S else "bytes")}
    # K1 at (2, 2) and (1, 1) on the same states: the step's split into
    # the inverse pair, the PCG and the assembly (`time_split`); with
    # --parent every entry of this phase in turns with that build's
    ins = (qpos, qvel, act, tb, 1.0)
    k1_22 = CS.ControlStep(topo, cfg.env, model, (2, 2))
    k1_11 = CS.ControlStep(topo, cfg.env, model, (1, 1))
    k1_22(*ins)
    k1_11(*ins)
    torch.cuda.synchronize()
    split_ms = {k: cuda_ms(fn, 10) for k, fn in (
        ("k1_22", lambda: k1_22(*ins)), ("k1_11", lambda: k1_11(*ins)))}
    split24 = time_split(split_ms["k1_22"], split_ms["k1_11"], head_ms,
                         tail_ms, cfg.env.frame_skip)
    parent24 = None
    if parent_libs is not None:
        pk = {k: on_library(x, parent_libs[24]) for k, x in (
            ("k1", CS.ControlStep(topo, cfg.env, model, (1, 2))),
            ("k1_22", CS.ControlStep(topo, cfg.env, model, (2, 2))),
            ("k1_11", CS.ControlStep(topo, cfg.env, model, (1, 1))),
            ("k2", K2.ControlStepSplit(topo, cfg.env, model, 2)),
            ("k2b", K2.ControlStepSplit(topo, cfg.env, model, 2,
                                        precond_bf16=True)),
            ("k2b_one", CS.ControlStep(topo, cfg.env, model, (2, 2),
                                       precond_bf16=True)))}
        parent24 = against_parent({
            "k1": (lambda: step(*ins), lambda: pk["k1"](*ins)),
            "k1_22": (lambda: k1_22(*ins), lambda: pk["k1_22"](*ins)),
            "k1_11": (lambda: k1_11(*ins), lambda: pk["k1_11"](*ins)),
            "head": (lambda: split.head(*ins), lambda: pk["k2"].head(*ins)),
            "tail": (lambda: split.tail(qh, vh, act, tb, X, 1.0),
                     lambda: pk["k2"].tail(qh, vh, act, tb, X, 1.0)),
            "k2b_head": (lambda: k2b.head(*ins),
                         lambda: pk["k2b"].head(*ins)),
            "k2b_tail": (lambda: k2b.tail(qhb, vhb, act, tb, Xb, 1.0),
                         lambda: pk["k2b"].tail(qhb, vhb, act, tb, Xb, 1.0)),
            "k2b_one": (lambda: k1b(*ins), lambda: pk["k2b_one"](*ins))},
            10)
        pt = {k: v["parent_ms"] for k, v in parent24["turns"].items()}
        parent24["split"] = time_split(pt["k1_22"], pt["k1_11"], pt["head"],
                                       pt["tail"], cfg.env.frame_skip)
    done("time", kernel_ms=kernel_ms, plain_ms=plain_ms,
         substeps_per_s=B_TIME * cfg.env.frame_skip / (kernel_ms / 1e3),
         flops_per_step=flops, bound_ms=bound_ms, bound_by=bound_by,
         env_steps_per_s=B_TIME * n_env / env_s,
         env_step_ms=1e3 * env_s / n_env, timed_launches=timed_launches,
         k2_head_ms=head_ms, k2_tail_ms=tail_ms,
         k2_plain_head_ms=plain_head_ms, k2_plain_tail_ms=plain_tail_ms,
         k2_bound=k2_bound, k2b=k2b_t, k1_22_ms=split_ms["k1_22"],
         k1_11_ms=split_ms["k1_11"], split=split24, parent=parent24,
         card=smi)

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
    parent_e = None
    if parent_libs is not None:
        pk1e = on_library(CS.ControlStep(topo, shape_env, smodel, (1, 2)),
                          parent_libs[24])
        parent_e = against_parent({"k1e": (
            lambda: k1e(qe, ve, acte, tbe, 1.0, seqe),
            lambda: pk1e(qe, ve, acte, tbe, 1.0, seqe))}, 10)
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
         library_rows=k1e.num_models, parent=parent_e, card=smi)

    phase("time_big", f"(K1d at (2, 2) and (1, 1), K2 and K2b on SMPL-H "
                      f"and masterfoot, uhc_implicit, B={B_BIG_TIME}; in "
                      "turns with the --parent build where given; plain "
                      f"versions at B={B_BIG_TIME[0]})")
    gen_b = torch.Generator().manual_seed(14)
    big_time = {}
    for fam, nb in BIG:
        btopo, benv, bmodel, blib = big_tree(fam, dev)
        k1d = CS.ControlStep(btopo, benv, bmodel, (2, 2))
        k1d11 = CS.ControlStep(btopo, benv, bmodel, (1, 1))
        split = K2.ControlStepSplit(btopo, benv, bmodel, 2)
        k2b = K2.ControlStepSplit(btopo, benv, bmodel, 2, precond_bf16=True)
        per_env_ws = build.layout(k1d.library())["workspace"]
        row = {"bodies": nb, "nv": btopo.nv}
        for B in B_BIG_TIME:
            qpos, qvel, tb = draw_big_states(blib, btopo.nv, B, gen_b, dev)
            act = (0.02 * torch.randn((B, k1d.act_dim),
                                      generator=gen_b)).to(dev)
            ins = (qpos, qvel, act, tb, 1.0)
            k1d(*ins)
            k1d11(*ins)
            qh, vh, X = split.head(*ins)
            split.tail(qh, vh, act, tb, X, 1.0)
            torch.cuda.synchronize()
            reps = 5 if B >= 2048 else 10
            this = {"k1d": lambda: k1d(*ins), "k1d_11": lambda: k1d11(*ins),
                    "head": lambda: split.head(*ins),
                    "tail": lambda: split.tail(qh, vh, act, tb, X, 1.0)}
            if parent_libs is None:
                t = {f"{k}_ms": cuda_ms(fn, reps) for k, fn in this.items()}
            else:
                p1, p11, psplit = (on_library(x, parent_libs[nb]) for x in (
                    CS.ControlStep(btopo, benv, bmodel, (2, 2)),
                    CS.ControlStep(btopo, benv, bmodel, (1, 1)),
                    K2.ControlStepSplit(btopo, benv, bmodel, 2)))
                t = {"parent": against_parent({
                    "k1d": (this["k1d"], lambda: p1(*ins)),
                    "k1d_11": (this["k1d_11"], lambda: p11(*ins)),
                    "head": (this["head"], lambda: psplit.head(*ins)),
                    "tail": (this["tail"], lambda: psplit.tail(
                        qh, vh, act, tb, X, 1.0))}, reps)}
                turns = t["parent"]["turns"]
                t.update({f"{k}_ms": v["ms"] for k, v in turns.items()})
                t["parent"]["split"] = time_split(
                    *(turns[k]["parent_ms"]
                      for k in ("k1d", "k1d_11", "head", "tail")),
                    benv.frame_skip)
            t["split"] = time_split(t["k1d_ms"], t["k1d_11_ms"],
                                    t["head_ms"], t["tail_ms"],
                                    benv.frame_skip)
            # K2b at the same inputs after K2
            qhb, vhb, Xb = k2b.head(*ins)
            k2b.tail(qhb, vhb, act, tb, Xb, 1.0)
            torch.cuda.synchronize()
            this = {"k2b_head": lambda: k2b.head(*ins),
                    "k2b_tail": lambda: k2b.tail(qhb, vhb, act, tb, Xb, 1.0)}
            if parent_libs is None:
                t.update({f"{k}_ms": cuda_ms(fn, reps)
                          for k, fn in this.items()})
            else:
                pk2b = on_library(K2.ControlStepSplit(
                    btopo, benv, bmodel, 2, precond_bf16=True),
                    parent_libs[nb])
                cmp = against_parent({
                    "k2b_head": (this["k2b_head"], lambda: pk2b.head(*ins)),
                    "k2b_tail": (this["k2b_tail"], lambda: pk2b.tail(
                        qhb, vhb, act, tb, Xb, 1.0))}, reps)
                for k in ("turns", "equal_outputs"):
                    t["parent"][k].update(cmp[k])
                t.update({f"{k}_ms": v["ms"] for k, v in cmp["turns"].items()})
            t["k2b_over_k2"] = ((t["k2b_head_ms"] + t["k2b_tail_ms"])
                                / (t["head_ms"] + t["tail_ms"]))
            trace = []
            SV.do_simulation(btopo, benv, bmodel, qpos, qvel, act, tb, 1.0,
                             (2, 2), trace=trace)
            state_io = (qpos.numel() * 2 + qvel.numel() * 2 + act.numel()
                        + tb.numel() + k1d.params.size + k1d.itab.size)
            t["bound"] = {part: bound(CS.control_step_flops(
                btopo, benv, tr, (2, 2), st), 4 * (state_io + extra))
                for part, tr, st, extra in (
                    ("k1d", trace, 0, 0), ("head", trace[:1], 0, X.numel()),
                    ("tail", trace[1:], 1, X.numel()),
                    ("k2b_head", trace[:1], 0, Xb.numel() // 2),
                    ("k2b_tail", trace[1:], 1, Xb.numel() // 2))}
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
                t["plain_k2b_head_ms"] = cuda_ms(lambda: K2.head_reference(
                    btopo, benv, bmodel, qpos, qvel, act, tb, 1.0, 2,
                    precond_bf16=True), 1)
                t["plain_k2b_tail_ms"] = cuda_ms(lambda: K2.tail_reference(
                    btopo, benv, bmodel, qhb, vhb, act, tb, Xb, 1.0, 2,
                    precond_bf16=True), 1)
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
        if parent_libs is not None:
            pk1f = on_library(CS.ControlStep(topo, env_cfg, model, (1, 2)),
                              parent_libs[24])
            k1f_time[mode]["parent"] = against_parent({"k1f": (
                lambda: k1f(qpos, qvel, actf, tb, 1.0),
                lambda: pk1f(qpos, qvel, actf, tb, 1.0))}, 10)
    done("time_k1f", **k1f_time, card=smi)

    phase("time_k1f_big", f"(K1f explicit and meta_joint on SMPL-H and "
                          f"masterfoot, B={B_BIG_TIME}, beside K1d on the "
                          "same states in turns K1d, K1f, K1f, K1d; K1f at "
                          "(1, 1); in turns with the --parent build where "
                          f"given; plain versions at B={B_BIG_TIME[0]})")
    gen_fb = torch.Generator().manual_seed(18)
    k1f_big_time = {}
    for fam, nb in BIG:
        btopo, benv, bmodel, blib = big_tree(fam, dev)
        k1d = CS.ControlStep(btopo, benv, bmodel, (2, 2))
        k1f_big_time[fam] = {}
        for mode in ("explicit", "meta_joint"):
            env_cfg = on_tree(k1f_modes()[mode], fam)
            k1f = CS.ControlStep(btopo, env_cfg, bmodel, (2, 2))
            k1f11 = CS.ControlStep(btopo, env_cfg, bmodel, (1, 1))
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
                ins = (qpos, qvel, actf, tb, 1.0)
                this = {"k1f": lambda: k1f(*ins),
                        "k1f_11": lambda: k1f11(*ins)}
                k1f11(*ins)
                if parent_libs is None:
                    t["k1f_11_ms"] = cuda_ms(this["k1f_11"], reps)
                else:
                    p22, p11 = (on_library(CS.ControlStep(
                        btopo, env_cfg, bmodel, it), parent_libs[nb])
                        for it in ((2, 2), (1, 1)))
                    t["parent"] = against_parent({
                        "k1f": (this["k1f"], lambda: p22(*ins)),
                        "k1f_11": (this["k1f_11"], lambda: p11(*ins))},
                        reps)
                    pturns = t["parent"]["turns"]
                    t["k1f_11_ms"] = pturns["k1f_11"]["ms"]
                    k2t = big_time[fam][f"B{B}"]["parent"]["turns"]
                    t["parent"]["split"] = time_split(
                        pturns["k1f"]["parent_ms"],
                        pturns["k1f_11"]["parent_ms"],
                        k2t["head"]["parent_ms"], k2t["tail"]["parent_ms"],
                        env_cfg.frame_skip)
                # the inverse pair from K2's head and tail in time_big
                k2 = big_time[fam][f"B{B}"]
                t["split"] = time_split(t["k1f_ms"], t["k1f_11_ms"],
                                        k2["head_ms"], k2["tail_ms"],
                                        env_cfg.frame_skip)
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
    if parent_libs is not None:
        pk1g = on_library(CS.ControlStep(topo, cfg.env, model, (1, 1),
                                         refresh_at=REFRESH_AT),
                          parent_libs[24])
        k1g_time["parent"] = against_parent({"k1g": (
            lambda: k1g(qpos, qvel, act, tb, 1.0),
            lambda: pk1g(qpos, qvel, act, tb, 1.0))}, 10)
    done("time_k1g", **k1g_time, card=smi)

    phase("time_smplx", f"(K2 head and tail on SMPL-X, B={B_BIG_TIME}; "
                        f"plain versions at B={B_BIG_TIME[0]})")
    gen_x = torch.Generator().manual_seed(22)
    xtopo, xenv, xmodel, xlib = smplx_tree(dev)
    split_x = K2.ControlStepSplit(xtopo, xenv, xmodel, 2)
    smplx_time = {"bodies": xtopo.nbody, "nv": xtopo.nv}
    for B in B_BIG_TIME:
        qpos, qvel, tb = draw_big_states(xlib, xtopo.nv, B, gen_x, dev)
        act = (0.02 * torch.randn((B, split_x.act_dim),
                                  generator=gen_x)).to(dev)
        qh, vh, X = split_x.head(qpos, qvel, act, tb, 1.0)
        split_x.tail(qh, vh, act, tb, X, 1.0)
        torch.cuda.synchronize()
        reps = 5 if B >= 2048 else 10
        t = {"head_ms": cuda_ms(lambda: split_x.head(qpos, qvel, act, tb,
                                                     1.0), reps),
             "tail_ms": cuda_ms(lambda: split_x.tail(qh, vh, act, tb, X,
                                                     1.0), reps)}
        trace = []
        SV.do_simulation(xtopo, xenv, xmodel, qpos, qvel, act, tb, 1.0,
                         (2, 2), trace=trace)
        state_io = (qpos.numel() * 2 + qvel.numel() * 2 + act.numel()
                    + tb.numel() + split_x.params.size + split_x.itab.size)
        t["bound"] = {part: bound(CS.control_step_flops(
            xtopo, xenv, tr, (2, 2), st), 4 * (state_io + X.numel()))
            for part, tr, st in (("head", trace[:1], 0),
                                 ("tail", trace[1:], 1))}
        t["substeps_per_s"] = B * xenv.frame_skip / (
            (t["head_ms"] + t["tail_ms"]) / 1e3)
        if B == B_BIG_TIME[0]:
            t["plain_head_ms"] = cuda_ms(lambda: K2.head_reference(
                xtopo, xenv, xmodel, qpos, qvel, act, tb, 1.0, 2), 1)
            t["plain_tail_ms"] = cuda_ms(lambda: K2.tail_reference(
                xtopo, xenv, xmodel, qh, vh, act, tb, X, 1.0, 2), 1)
        smplx_time[f"B{B}"] = t
    smplx_time["rollout_env_steps_per_s"] = rollout_x["env_steps_per_s"]
    done("time_smplx", **smplx_time, card=smi)

    src = "uhc_tpu_torch/csrc/control_step.cu"
    k2_src = "uhc_tpu/physics/pallas_substep.py:284"
    print(json.dumps({"kernels": [
        {"name": "control_step", "route": "cuda", "source": src,
         "replaces": "uhc_tpu/physics/pallas_lane.py:83",
         "launches": (launches + train_counts["train_lane"]["k1"]
                      + protocol_k1 + obj_k1 + tools_k1 + dp_k1),
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
                      + train_counts["train_dr"]["k1e"] + exact_counts["k1e"]),
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
             + train_counts["train_explicit"]["k1f"] + protocol_k1f),
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
         "bound_by": k1g_time["bound"]["bound_by"], "library_ms": None}]
        + smplx_rows(src, k2_src, (rollout_x, rollout_xd),
                     {**k2x_errs, **{f"data_{m}": e
                                     for m, e in xd_errs.items()}},
                     smplx_time)
        + k2b_rows(src, k2_src, bench_counts, k2b_errs, k2b_t)
        + toe_rows(src, k2_src, toe_errs, toe_roll, toe_t)}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="SRC",
                    help="another control_step.cu to time in turns with "
                         "this checkout's on the big trees")
    args = ap.parse_args()
    parent = os.path.abspath(args.parent) if args.parent else None
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(DEADLINE_S)
    try:
        return run(parent)
    except BaseException as exc:  # noqa: BLE001 - every failure exits 1
        traceback.print_exc()
        # the reason goes to stdout too, beside the phase lines
        print(f"FAILED in phase {_phase[0]}: {exc!r}", flush=True)
        return 1
    finally:
        signal.alarm(0)


if __name__ == "__main__":
    sys.exit(main())
