"""The checks chip_smoke.py holds K1 to on the stand-in's capsule and
box_feet variants (phase remove_toe's variant check), on its own draws
(`variant_draws`, made on the host from a seed).

Env 230 of the capsule draws is a state where the (1, 2) control step
grows a perturbation of its state more than a thousandfold over its last
eleven substeps: float64 steps from the state moved by one or two float32 ulps land off the bounds
of the unmoved float64 step, twice as far for twice the move. The growth
comes late in the step (after substep 8, as the substep-0 preconditioner
ages) and goes with more PCG iterations: at (8, 8) the same moves stay
well inside the bounds. No contact, limit or friction switch is involved.
Float32 rounding then puts every float32 computation of the step (the
plain version, K1) off the float64 one and off each other by more than
the bounds, which is why the capsule variant is held by `gate_big` (its
witnesses are these moved steps) and box_feet by `gate`. K1's source
built as host C++ stands in for the kernel."""
import shutil

import numpy as np
import pytest
import torch

import chip_smoke as C

EDGE = 230          # capsule env whose step amplifies rounding


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads while the module runs (the suite runs several
    test processes side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variants():
    """{name: (topo, env cfg, variant model, inputs, host K1's (qpos,
    qvel), plain (float32, float64))} of the variant check's draws."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.csrc import build
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    topo, model_np = load_fixture_humanoid()
    lib, _ = build_expert_library(
        topo, model_from_numpy(model_np, "cpu"),
        load_motion_file("sample_data/gait_clips.pkl"))
    env = Config.uhc_implicit().env
    host = build.load_host_library(topo.nbody)
    out = {}
    for name, vmodel, ins in C.variant_draws(topo, model_np, lib, "cpu"):
        step = CS.ControlStep(topo, env, vmodel, (1, 2))
        arrs = [np.ascontiguousarray(x.numpy()) for x in ins]
        res = [np.zeros_like(arrs[0]), np.zeros_like(arrs[1])]
        assert host.uhc_control_step_host(
            step.params.ctypes.data, None, step.itab.ctypes.data,
            *[a.ctypes.data for a in arrs + res], len(arrs[0]),
            step.act_dim, 1.0) == 0
        out[name] = (topo, env, vmodel, ins,
                     [torch.tensor(a) for a in res],
                     C.plain_pair(topo, env, vmodel, ins, (1, 2)))
    return out


def _off(q, v, ref):
    """Per env, the larger of |dqpos| and |dqvel| from `ref` in units of
    the bounds."""
    return torch.maximum((q - ref[0]).abs().amax(1) / C.QPOS_TOL,
                         (v - ref[1]).abs().amax(1) / C.QVEL_TOL)


def _moved_off(variants, env_id, pcg_iters=(1, 2), stop=None):
    """Distances in units of the bounds of the float64 steps from env
    `env_id`'s state moved by 1 ulp (first half) and 2 ulps (second half)
    from the unmoved float64 step (its first `stop` substeps alone where
    given)."""
    from uhc_tpu_torch.physics import solver

    topo, env, vmodel, ins, *_ = variants["capsule"]
    one = [x[env_id:env_id + 1].double() for x in ins]
    ref = solver.substeps(topo, env, C.double_model(vmodel), *one, 1.0,
                          pcg_iters, 0, env.frame_skip if stop is None
                          else stop)[:2]
    q, v = C.moved_steps(topo, env, vmodel, ins, env_id, torch.float64,
                         pcg_iters=pcg_iters, stop=stop)
    return _off(q, v, ref)


def test_capsule_env_230_amplifies_rounding(variants):
    """Float64 steps from env 230's state moved by 1-2 float32 ulps: every
    one lands off the bounds of the unmoved float64 step, the farthest at
    more than twice them, and the 2-ulp moves about twice as far as the
    1-ulp ones (a linear growth, not a switch); after 4 substeps, and at
    PCG (8, 8) after all 15, every moved step is within a tenth of the
    bounds; env 231's moved steps stay within a tenth of them."""
    off = _moved_off(variants, EDGE)
    half = len(off) // 2
    assert bool((off > 1).all()) and off.max().item() > 2
    assert 1.4 < (off[half:].median() / off[:half].median()).item() < 2.5
    assert _moved_off(variants, EDGE, stop=4).max().item() < 0.1
    assert _moved_off(variants, EDGE, pcg_iters=(8, 8)).max().item() < 0.1
    assert _moved_off(variants, EDGE + 1).max().item() < 0.1


def test_host_k1_on_capsule_needs_gate_big(variants):
    """The host build on the capsule draws: env 230 alone is off the
    bounds of either plain version, both plain versions miss each other
    there, and `gate` fails on it (kernel vs float32); `gate_big` passes
    it, env 230 its one miss."""
    topo, env, vmodel, ins, out, (p32, p64) = variants["capsule"]
    off = torch.maximum(_off(*out, p32), _off(*out, p64))
    assert torch.nonzero(off > 1)[:, 0].tolist() == [EDGE]
    assert _off(p32[0][EDGE:EDGE + 1], p32[1][EDGE:EDGE + 1],
                [t[EDGE:EDGE + 1] for t in p64]).item() > 1
    errs, fails = C.gate("host K1 capsule", out, p32, p64)
    assert errs["edge_envs"] == 1
    assert len(fails) == 1 and "kernel_vs_plain32" in fails[0]
    errs, fails = C.gate_big(
        "host K1 capsule", out, p32, p64,
        lambda ev: [C.moved_steps(topo, env, vmodel, ins, ev, dt,
                                  pcg_iters=(1, 2))
                    for dt in (torch.float64, torch.float32)])
    assert not fails, fails
    assert [r["env"] for r in errs["kernel_missed_envs"]] == [EDGE]


def test_host_k1_on_box_feet_passes_gate(variants):
    """The host build on the box_feet draws passes `gate` with no edge
    env."""
    *_, out, (p32, p64) = variants["box_feet"]
    errs, fails = C.gate("host K1 box_feet", out, p32, p64)
    assert not fails, fails
    assert errs["edge_envs"] == 0
