#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (uhc_tpu_torch) runs on an NVIDIA
H100: builds every hand-written kernel from this checkout, holds each
against its plain PyTorch version on the card, drives the main path
(closed-loop copycat evaluation of every clip of
sample_data/gait_clips.pkl at full width, seeded weights), checks its
output, and times the kernels at B=2048.

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
B_CHECK, B_TIME = 256, 2048

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


def run() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "uhc_tpu_torch")):
        raise RuntimeError(f"no uhc_tpu_torch package next to {__file__}: "
                           "run this script from a checkout of the repo")
    sys.path.insert(0, here)
    os.chdir(here)

    phase("device")
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this "
                           "script needs a CUDA card")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip().splitlines()[0]
    done("device", card=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         python=sys.version.split()[0], count=torch.cuda.device_count())

    phase("build", "(nvcc, sm_90a)")
    from uhc_tpu_torch.csrc import build

    t0 = time.perf_counter()
    lib_cuda = build.load_library()
    ptxas = [ln.strip() for ln in build.build_log.get(
        "cuda", {}).get("stderr", "").splitlines()
        if "registers" in ln or "spill" in ln]
    done("build", seconds=time.perf_counter() - t0,
         layout=build.layout(lib_cuda), ptxas=ptxas)

    phase("kernel_vs_plain", f"(B={B_CHECK}, plain PD and meta-PD)")
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics import control_step as CS
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
    for mode, env_cfg in (("plain_pd", cfg.env),
                          ("meta_pd", dataclasses.replace(cfg.env,
                                                          meta_pd=True))):
        step = CS.ControlStep(topo, env_cfg, model, pcg_iters=(1, 2))
        qpos, qvel, tb = draw_states(lib, B_CHECK, gen, dev)
        act = (0.02 * torch.randn((B_CHECK, step.act_dim),
                                  generator=gen)).to(dev)
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

    phase("eval", "(all clips, full length, seeded weights, kernel)")
    from uhc_tpu_torch.cli.eval import run_eval

    CS.reset_launches()
    res = run_eval("sample_data/gait_clips.pkl", device=dev, seed=0)
    launches = CS.LAUNCHES
    traj = res["traj"]
    S, T = len(keys), res["control_steps"]
    if launches != T:
        raise RuntimeError(f"control-step kernel launched {launches} times "
                           f"for {T} control steps")
    if tuple(traj["pred_qpos"].shape) != (S, T, 76) or not bool(
            torch.isfinite(traj["pred_qpos"]).all()):
        raise RuntimeError("eval trajectory has the wrong shape or is not "
                           "finite")
    if not all(np.isfinite(v) for v in res["summary"].values()):
        raise RuntimeError(f"eval summary not finite: {res['summary']}")
    done("eval", launches=launches, control_steps=T,
         ms_per_step=res["ms_per_step"], summary=res["summary"])

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
    done("time", kernel_ms=kernel_ms, plain_ms=plain_ms,
         substeps_per_s=B_TIME * cfg.env.frame_skip / (kernel_ms / 1e3),
         flops_per_step=flops, bound_ms=bound_ms, bound_by=bound_by,
         env_steps_per_s=B_TIME * n_env / env_s,
         env_step_ms=1e3 * env_s / n_env, timed_launches=timed_launches,
         card=smi)

    print(json.dumps({"kernels": [{
        "name": "control_step", "route": "cuda",
        "source": "uhc_tpu_torch/csrc/control_step.cu",
        "replaces": "uhc_tpu/physics/pallas_lane.py:83",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
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
