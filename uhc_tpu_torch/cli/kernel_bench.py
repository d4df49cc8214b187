"""Control-step kernel timing harness (PyTorch twin of
tools/kernel_bench.py): times rows of control-step kernel configurations,
one JSON line per row.

Usage:
  [B=2048] [STEPS=20] python -m uhc_tpu_torch.cli.kernel_bench
      [--device cpu] "SPLIT=1,PCG=2,BF16=1,MODEL=smplh" ...

Each positional argument is one row, comma-separated KEY=VALUE pairs with
the JAX tool's keys and defaults (`parse_cfg`); without one the JAX
tool's default row runs. The B and STEPS environment variables set the
batch and the control steps per run. MODEL picks the tree, built from
the stand-in humanoid as the JAX tool builds it: `smpl` (24 bodies),
`masterfoot` (48) or `smplh` (52). A row routes as the JAX tool does:
- LANE=1: `ControlStep` (K1, K1d) at (PCGPD, PCG), or at PCG on both
  solves when PCGPD is 0, with refresh_at=REFRESH (K1g) when it is set;
- otherwise the head/tail pair `ControlStepSplit` (K2) at PCG with
  SPLIT=1, or `ControlStep` at (PCG, PCG) with SPLIT=0, the bfloat16
  preconditioner (K2b) with BF16=1;
- SC=1 turns self-collision on (the rows run without it by default).
The TPU tiling keys (E, V, TAIL, SUB, PCGV, PCGVS) and the settled
CONDINV and MERGEJ6 select no other function on the card: they are
accepted and listed under "no_effect_on_card" in every line.

The states are the first frames of the first clip of
sample_data/gait_clips.pkl (its first 4 frames), the same for every env,
remapped through the masterfoot converter or routed onto SMPL-H with flat
hands; the actions are seeded and held. A row runs STEPS control steps
with the state fed back twice: once to build the kernel and warm up
(`build_s`), once timed, with CUDA events on the card and the host clock
on the CPU, where the plain versions run. The line has the JAX tool's
fields (`build_s` in place of `compile_s`, times unrounded), the launches
of the timed run in `control_step.LAUNCHES`, the device and, on a card,
its name and power limit as nvidia-smi gives them. A row that fails
raises.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

GAIT = "sample_data/gait_clips.pkl"
KEYS = {"E": 8, "PCG": 3, "V": 100, "SPLIT": 0, "TAIL": 16, "SC": 0,
        "BF16": 0, "LANE": 0, "SUB": 16, "PCGV": 0, "PCGPD": 0,
        "REFRESH": 0, "PCGVS": 0, "CONDINV": 0, "MERGEJ6": 0,
        "MODEL": "smpl"}
NO_EFFECT_ON_CARD = ("E", "V", "TAIL", "SUB", "PCGV", "PCGVS", "CONDINV",
                     "MERGEJ6")
DEFAULT_ROW = "E=8,PCG=3,V=100"


def parse_cfg(s: str) -> dict:
    """"K=V,..." -> the row's settings over the JAX tool's defaults."""
    out = dict(KEYS)
    for kv in s.split(","):
        k, v = kv.split("=")
        k = k.upper()
        if k not in KEYS:
            raise ValueError(f"unknown key {k!r} (keys: {', '.join(KEYS)})")
        out[k] = v if k == "MODEL" else int(v)
    return out


def build_family(name: str, topo24, model24):
    """The tree of MODEL from the 24-body humanoid -> (topo, model with
    numpy leaves, converter or None)."""
    if name == "masterfoot":
        from uhc_tpu_torch.smpl.masterfoot import masterfoot_model

        return masterfoot_model(topo24, model24, 30.0)
    if name == "smplh":
        from uhc_tpu_torch.smpl.smplh import smplh_model, smplh_topology

        return smplh_topology(), smplh_model(topo24, model24), None
    if name != "smpl":
        raise ValueError(f"MODEL={name}: smpl, masterfoot or smplh")
    return topo24, model24, None


def family_state(name: str, topo, model, conv, topo24, model24, device):
    """(qpos (nq,), target_base (ndof,)) of the row's tree: the first two
    frames of the first gait clip."""
    from uhc_tpu_torch.data.dataset import (_pose_to_qpose,
                                            build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    seqs = load_motion_file(GAIT)
    first = next(iter(seqs))
    if name == "smplh":
        # a 72-dof SMPL clip on the 52-body tree: flat-hand routing
        q2 = _pose_to_qpose(topo, model_from_numpy(model, device),
                            seqs[first]["pose_aa"][:2], None, device)
        return q2[0], q2[1, 7:]
    lib, _ = build_expert_library(topo24, model_from_numpy(model24, device),
                                  {first: seqs[first]}, max_len=4)
    qp, q1 = lib["qpos"][0, 0], lib["qpos"][0, 1]
    if conv is not None:
        qp, q1 = conv.qpos_smpl_2_new(qp), conv.qpos_smpl_2_new(q1)
    return qp, q1[7:]


def make_step(c: dict, topo, env_cfg, model):
    """The row's kernel wrapper."""
    from uhc_tpu_torch.physics.control_step import ControlStep
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit

    if c["LANE"]:
        iters = (c["PCGPD"], c["PCG"]) if c["PCGPD"] else c["PCG"]
        return ControlStep(topo, env_cfg, model, iters,
                           refresh_at=c["REFRESH"] or None)
    if c["SPLIT"]:
        return ControlStepSplit(topo, env_cfg, model, c["PCG"],
                                precond_bf16=bool(c["BF16"]))
    return ControlStep(topo, env_cfg, model, (c["PCG"], c["PCG"]),
                       precond_bf16=bool(c["BF16"]))


def run_row(c: dict, family, B: int, steps: int, device) -> dict:
    """Build, warm up and time one row -> its JSON line as a dict."""
    from uhc_tpu_torch.config.config import EnvConfig
    from uhc_tpu_torch.device import card_line
    from uhc_tpu_torch.physics import control_step as CS

    topo, model, qp00, tb0 = family
    env_cfg = EnvConfig(self_collision=bool(c["SC"]))
    step = make_step(c, topo, env_cfg, model)
    gen = torch.Generator().manual_seed(0)
    actions = (0.01 * torch.randn((B, step.act_dim), generator=gen)).to(
        device)
    qp0 = qp00[None].expand(B, -1).contiguous()
    qv0 = torch.zeros((B, topo.nv), device=device)
    tb = tb0[None].expand(B, -1).contiguous()
    cuda = device.type == "cuda"

    def run(qp, qv):
        z = None
        for _ in range(steps):
            z = qp[:, 2]
            qp, qv = step(qp, qv, actions, tb, 1.0)
        return qp, qv, z

    t0 = time.perf_counter()
    qp, qv, _ = run(qp0, qv0)
    if cuda:
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    before = dict(CS.LAUNCHES)
    if cuda:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        qp, qv, z = run(qp, qv)
        e1.record()
        torch.cuda.synchronize(device)
        dt = e0.elapsed_time(e1) / 1e3
    else:
        t0 = time.perf_counter()
        qp, qv, z = run(qp, qv)
        dt = time.perf_counter() - t0
    if not bool(torch.isfinite(qp).all() & torch.isfinite(qv).all()):
        raise RuntimeError(f"{c}: the state is not finite after "
                           f"{2 * steps} control steps")
    return {
        "cfg": ",".join(f"{k}={v}" for k, v in c.items()),
        "substeps_per_sec": B * steps * env_cfg.frame_skip / dt,
        "ms_per_ctrl_step": dt / steps * 1e3,
        "build_s": build_s,
        "mean_root_z": z.mean().item(),
        "kernel": type(step).__name__, "bodies": topo.nbody, "B": B,
        "steps": steps,
        "launches": {f"{e}/{nb}{'/library' if lib else ''}":
                     n - before.get((e, nb, lib), 0)
                     for (e, nb, lib), n in sorted(CS.LAUNCHES.items())
                     if n > before.get((e, nb, lib), 0)},
        "device": str(device), "timer": "cuda_events" if cuda else "host",
        "card": card_line() if cuda else None,
        "no_effect_on_card": {k: c[k] for k in NO_EFFECT_ON_CARD}}


def main(argv=None):
    from uhc_tpu_torch.device import resolve_device
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    p = argparse.ArgumentParser(
        prog="python -m uhc_tpu_torch.cli.kernel_bench")
    p.add_argument("rows", nargs="*", help="K=V,... (tools/kernel_bench.py "
                   "keys); default: " + DEFAULT_ROW)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    B = int(os.environ.get("B", 2048))
    steps = int(os.environ.get("STEPS", 20))
    topo24, model24 = load_fixture_humanoid()
    families, lines = {}, []
    for c in [parse_cfg(r) for r in args.rows or [DEFAULT_ROW]]:
        if c["MODEL"] not in families:
            topo, model, conv = build_family(c["MODEL"], topo24, model24)
            qp00, tb0 = family_state(c["MODEL"], topo, model, conv, topo24,
                                     model24, device)
            families[c["MODEL"]] = (topo, model_from_numpy(model, device),
                                    qp00, tb0)
        line = run_row(c, families[c["MODEL"]], B, steps, device)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
