"""K1f on the big trees through the check chip_smoke.py holds it to
(`gate_big`), on the CPU: K1f's CUDA source built as host C++ for the
52-body SMPL-H and the 48-body masterfoot (-DNB) in place of the kernel,
on phase k1f_big's own draws (`chip_smoke.k1f_big_draws`: 256 clip-frame
envs per tree and mode, one in four lowered 2 cm, made on the host from a
seed), against its float32 and float64 plain versions at PCG (2, 2).

On these frames a hull point within float32 rounding of the ground plane,
and two PCG iterations, spread float32 results beyond the bounds of
tests/test_fused_split.py on a few envs: the float32 plain version misses
the float64 one there too (masterfoot explicit_ground: 5 of 256 envs), and
the gate holds each env the build misses to the float32 version's worst
miss or to a witness (PERF.md §2). Zeroing the wrench or the per-dof gain
columns moves the build's qpos by more than 1e-5, so neither term is
dropped."""
import shutil

import numpy as np
import pytest
import torch

import chip_smoke as C


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads while the module runs (the suite runs several
    test processes side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def draws():
    """{(family, mode): (topo, env cfg, model, inputs)} of phase
    k1f_big."""
    return {(fam, mode): (topo, env_cfg, model, ins)
            for fam, mode, topo, env_cfg, model, ins
            in C.k1f_big_draws("cpu")}


def _host_k1f(step, ins):
    """One launch of the host build of K1f for the step's tree."""
    from uhc_tpu_torch.csrc import build
    from uhc_tpu_torch.physics import control_step as CS

    lib = build.load_host_library(step.topo.nbody)
    assert build.layout(lib)["itab"] == step.itab.size
    ops = CS.k1f_operands(step.topo, step.cfg, step.model_on("cpu"), ins[2])
    arrs = [np.ascontiguousarray(x.numpy()) for x in ins]
    opa = [None if x is None else np.ascontiguousarray(x.numpy())
           for x in ops]
    out = [np.zeros_like(arrs[0]), np.zeros_like(arrs[1])]
    assert lib.uhc_control_step_f_host(
        step.params.ctypes.data, None, step.itab.ctypes.data,
        *[a.ctypes.data for a in arrs + out],
        *[None if x is None else x.ctypes.data for x in opa],
        len(arrs[0]), step.act_dim, 1.0) == 0
    return [torch.tensor(a) for a in out]


@pytest.mark.parametrize("mode", C.K1F_BIG_MODES)
@pytest.mark.parametrize("family", ["smplh", "masterfoot"])
def test_host_k1f_big_passes_the_gate(draws, family, mode):
    """The host build of K1f at (2, 2) on phase k1f_big's draws through
    `gate_big` (qpos 1e-5, qvel 1e-3): no failure, most envs sharp and
    within the bounds of the float32 plain version; zeroing each term
    (on the first 32 envs) moves qpos by more than 1e-5."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from uhc_tpu_torch.physics import control_step as CS

    topo, env_cfg, model, ins = draws[family, mode]
    step = CS.ControlStep(topo, env_cfg, model, (2, 2))
    assert step.k1f and len(ins[0]) == C.B_CHECK
    out = _host_k1f(step, list(ins))
    assert all(bool(torch.isfinite(t).all()) for t in out)
    plain32, plain64 = C.plain_pair(topo, env_cfg, model, ins, (2, 2))
    errs, fails = C.gate_big(
        f"host K1f {family} {mode}", out, plain32, plain64,
        lambda e: [C.moved_steps(topo, env_cfg, model, ins, e, dt)
                   for dt in (torch.float64, torch.float32)])
    assert not fails, (fails, errs["kernel_missed_envs"])
    assert errs["sharp_envs"] > C.B_CHECK // 2
    dq, dv = errs["kernel_vs_plain32_sharp"]
    assert dq <= C.QPOS_TOL and dv <= C.QVEL_TOL
    few = [x[:32] for x in ins]
    for term, act0 in C.k1f_zeroed(topo, env_cfg, few[2]).items():
        zeroed = _host_k1f(step, [few[0], few[1], act0, few[3]])
        assert (zeroed[0] - out[0][:32]).abs().max().item() > 1e-5, term
