#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (uhc_tpu_torch) runs on an NVIDIA
H100: builds every hand-written kernel from this checkout (K1, the
one-launch control step, and K2, its head/tail split), holds each against
its plain PyTorch version on the card, drives the main paths at full
width with seeded weights -- closed-loop copycat evaluation of every clip
of sample_data/gait_clips.pkl through K1, and PPO training through
cli/train with 1024 envs × 48 steps, through K1 (default routing) and
through K2 (UHC_TPU_LANE=0) -- checks their output, and times the kernels
at B=2048.

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

DEADLINE_S = 600
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

_phase = ["start"]


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


def run_train(lane, epochs: int, name: str, dev) -> dict:
    """Drive cli/train on the card with UHC_TPU_LANE=`lane` (None: unset,
    the default routing) and check it: launches of the routed kernel
    exactly one per control step and none of the other, finite stats, the
    value loss falling across every update, and a checkpoint that reloads
    to the same policy bit for bit. Returns the launch counts."""
    import tempfile

    import numpy as np
    import torch

    from uhc_tpu_torch.cli import train
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    if lane is None:
        os.environ.pop("UHC_TPU_LANE", None)
    else:
        os.environ["UHC_TPU_LANE"] = lane
    try:
        with tempfile.TemporaryDirectory() as out:
            CS.reset_launches()
            K2.reset_launches()
            agent, hist = train.main(TRAIN_ARGS + [
                "--epochs", str(epochs), "--results-dir", out])
            got = {"k1": CS.LAUNCHES, "k2_head": K2.HEAD_LAUNCHES,
                   "k2_tail": K2.TAIL_LAUNCHES}
            steps = epochs * agent.horizon
            want = ({"k1": steps, "k2_head": 0, "k2_tail": 0} if lane is None
                    else {"k1": 0, "k2_head": steps, "k2_tail": steps})
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
            policy = nets.policy_from_numpy(ck["policy_params"], "relu", dev)
            x = torch.randn((agent.num_envs, agent.obs_dim),
                            generator=torch.Generator().manual_seed(5)).to(dev)
            with torch.no_grad():
                same = torch.equal(policy(x), agent.policy(x))
            if not same:
                raise RuntimeError(f"{name}: reloaded checkpoint gives "
                                   f"another policy mean")
    finally:
        os.environ.pop("UHC_TPU_LANE", None)
    done(name, launches=got, epochs=epochs,
         rollout_env_steps_per_s=[st["rollout_steps_per_sec"]
                                  for st in hist],
         ppo_update_ms=[1e3 * st["T_update"] for st in hist],
         epoch_s=[st["T_total"] for st in hist],
         reward_mean=[st["reward_mean"] for st in hist],
         value_loss_before=[st["value_loss_before"] for st in hist],
         value_loss_after=[st["value_loss"] for st in hist],
         episodes=[st["episodes"] for st in hist], checkpoint_equal=True)
    return got


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

    phase("build", "(nvcc, sm_90a)")
    from uhc_tpu_torch.csrc import build

    t0 = time.perf_counter()
    lib_cuda = build.load_library()
    ptxas = [ln.strip() for ln in build.build_log.get(
        "cuda", {}).get("stderr", "").splitlines()
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    done("build", seconds=time.perf_counter() - t0,
         layout=build.layout(lib_cuda), ptxas=ptxas)

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

    def reset_counts():
        CS.reset_launches()
        K2.reset_launches()

    def counts():
        return {"k1": CS.LAUNCHES, "k2_head": K2.HEAD_LAUNCHES,
                "k2_tail": K2.TAIL_LAUNCHES}

    phase("eval", "(all clips, full length, seeded weights, kernel)")
    from uhc_tpu_torch.cli.eval import run_eval

    reset_counts()
    res = run_eval("sample_data/gait_clips.pkl", device=dev, seed=0)
    eval_counts = counts()
    launches = eval_counts["k1"]
    traj = res["traj"]
    S, T = len(keys), res["control_steps"]
    if eval_counts != {"k1": T, "k2_head": 0, "k2_tail": 0}:
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

    train_counts = {}
    for train_phase, lane, epochs in (("train_lane", None, 3),
                                      ("train_split", "0", 2)):
        phase(train_phase, f"(cli/train, 1024 envs × 48 steps, {epochs} "
                           f"epochs, UHC_TPU_LANE={lane or 'unset'})")
        train_counts[train_phase] = run_train(lane, epochs, train_phase, dev)


    phase("time", f"(B={B_TIME}, uhc_implicit control step)")
    step = CS.ControlStep(topo, cfg.env, model, pcg_iters=(1, 2))
    qpos, qvel, tb = draw_states(lib, B_TIME, gen, dev)
    act = (0.02 * torch.randn((B_TIME, step.act_dim),
                              generator=gen)).to(dev)
    n0 = CS.LAUNCHES
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
    timed_launches = CS.LAUNCHES - n0

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
    ]}), flush=True)
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
