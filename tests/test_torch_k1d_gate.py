"""The check chip_smoke.py holds K1d to on the big trees (`gate_big`),
on its own draws (phase k1d_vs_plain, made on the host from a seed).

SMPL-H meta-PD env 229 of those draws has a hull point 1.2e-7 m above the
ground plane at substep 10: a step from its state moved by one or two
float32 ulps switches that ground contact on and lands 1.3879e-3 (qpos)
and 4.733e-2 (qvel) from the float64 plain step, which is where K1d landed
on the card (PERF.md). The gate passes such an answer by that witness and
fails a miss of the same size that no moved step reaches; the host build
of K1d passes it on the masterfoot draws. On a card
(marked gpu; run without tests/conftest.py, which needs JAX) K1d itself
goes through the gate."""
import shutil

import numpy as np
import pytest
import torch

import chip_smoke as C
from test_torch_helpers import BIG_FAMILIES, states

EDGE = 229          # SMPL-H meta-PD env at a ground-contact switch
# where K1d landed on env EDGE on the card, from the float64 plain step
CARD_QPOS, CARD_QVEL = 1.3879005616104778e-3, 4.733090973560128e-2


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads while the module runs (the suite runs several
    test processes side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smplh_meta():
    """(topo, env cfg, model, inputs) of phase k1d_vs_plain's SMPL-H
    meta-PD case."""
    for fam, mode, topo, env_cfg, model, ins in C.k1d_draws("cpu"):
        if (fam, mode) == ("smplh", "meta_pd"):
            return topo, env_cfg, model, ins


def _plain(topo, env_cfg, model, ins, dtype):
    from uhc_tpu_torch.physics import control_step as CS

    m = model if dtype == torch.float32 else C.double_model(model)
    return CS.control_step_reference(topo, env_cfg, m,
                                     *[x.to(dtype) for x in ins], 1.0,
                                     (2, 2))


def _far(q, v, ref):
    return ((q - ref[0]).abs().amax(1) > C.QPOS_TOL) | (
        (v - ref[1]).abs().amax(1) > C.QVEL_TOL)


def test_ulp_moves_switch_a_ground_contact_on_env_229(smplh_meta):
    """Float64 steps from env 229's state moved by 1-2 float32 ulps: some
    land where K1d did on the card (to 1e-5 / 1e-3), and each of those
    switched a ground contact that the unmoved step does not; a
    neighbouring env's moved steps all stay within the bounds."""
    from uhc_tpu_torch.physics import solver

    topo, env_cfg, model, ins = smplh_meta
    one = [x[EDGE:EDGE + 1] for x in ins]
    ref = _plain(topo, env_cfg, model, one, torch.float64)
    trace_ref, trace = [], []
    solver.do_simulation(topo, env_cfg, C.double_model(model),
                         *[x.double() for x in one], 1.0, (2, 2),
                         trace=trace_ref)
    q, v = C.moved_steps(topo, env_cfg, model, ins, EDGE, torch.float64,
                         trace=trace)
    off = _far(q, v, ref)
    assert 0 < int(off.sum()) < len(off)
    assert abs((q[off] - ref[0]).abs().amax(1).max().item()
               - CARD_QPOS) <= C.QPOS_TOL
    assert abs((v[off] - ref[1]).abs().amax(1).max().item()
               - CARD_QVEL) <= C.QVEL_TOL
    switched = np.stack([(t != r).any(1) for t, r in zip(trace, trace_ref)],
                        1)                            # (moves, substeps)
    assert switched[off.numpy()].any(1).all()
    q2, v2 = C.moved_steps(topo, env_cfg, model, ins, EDGE + 1,
                           torch.float64)
    assert not _far(q2, v2, _plain(topo, env_cfg, model,
                                   [x[EDGE + 1:EDGE + 2] for x in ins],
                                   torch.float64)).any()


def test_gate_big_passes_a_witnessed_miss_and_fails_another(smplh_meta):
    """gate_big over envs 224-231 of the draws: the float32 plain version
    passes; with env 229 replaced by a moved float64 step that switched
    the contact, it passes by the witness; with the same distance put on
    one joint of env 229 instead, it fails."""
    topo, env_cfg, model, ins = smplh_meta
    sub = [x[EDGE - 5:EDGE + 3].contiguous() for x in ins]
    e = 5
    p32 = _plain(topo, env_cfg, model, sub, torch.float32)
    p64 = _plain(topo, env_cfg, model, sub, torch.float64)

    def moved(env):
        return [C.moved_steps(topo, env_cfg, model, sub, env, dt)
                for dt in (torch.float64, torch.float32)]

    errs, fails = C.gate_big("plain32", p32, p32, p64, moved)
    assert not fails and errs["kernel_misses"] == 0
    q, v = C.moved_steps(topo, env_cfg, model, sub, e, torch.float64)
    i = int(_far(q, v, [t[e:e + 1] for t in p64]).nonzero()[0, 0])
    flipped = [t.clone() for t in p32]
    flipped[0][e], flipped[1][e] = q[i].float(), v[i].float()
    errs, fails = C.gate_big("flipped", flipped, p32, p64, moved)
    assert not fails, fails
    (row,) = errs["kernel_missed_envs"]
    assert row["env"] == e and row["passed_by"] == "witness"
    shifted = [t.clone() for t in p32]
    shifted[0][e, 7] += CARD_QPOS
    errs, fails = C.gate_big("shifted", shifted, p32, p64, moved)
    assert len(fails) == 1 and "env 5" in fails[0]
    assert errs["kernel_missed_envs"][0]["passed_by"] is None


def test_host_k1d_passes_the_gate_on_masterfoot():
    """K1d's source built as host C++ in place of the kernel, through
    gate_big on phase k1d_vs_plain's masterfoot plain-PD draws (256 envs):
    it passes, with misses of the float64 bounds on some envs, and within
    the bounds of the float32 plain version on the sharp envs."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from uhc_tpu_torch.csrc import build
    from uhc_tpu_torch.physics import control_step as CS

    for fam, mode, topo, env_cfg, model, ins in C.k1d_draws("cpu"):
        if (fam, mode) == ("masterfoot", "plain_pd"):
            break
    step = CS.ControlStep(topo, env_cfg, model, (2, 2))
    lib = build.load_host_library(topo.nbody)
    arrs = [np.ascontiguousarray(x.numpy()) for x in ins]
    out = [np.zeros_like(arrs[0]), np.zeros_like(arrs[1])]
    assert lib.uhc_control_step_host(
        step.params.ctypes.data, None, step.itab.ctypes.data,
        *[a.ctypes.data for a in arrs + out], len(arrs[0]), step.act_dim,
        1.0) == 0
    errs, fails = C.gate_big(
        "host K1d", [torch.tensor(a) for a in out],
        _plain(topo, env_cfg, model, ins, torch.float32),
        _plain(topo, env_cfg, model, ins, torch.float64),
        lambda e: [C.moved_steps(topo, env_cfg, model, ins, e, dt)
                   for dt in (torch.float64, torch.float32)])
    assert not fails, fails
    assert errs["kernel_misses"] > 0 and errs["sharp_envs"] > 128
    dq, dv = errs["kernel_vs_plain32_sharp"]
    assert dq <= C.QPOS_TOL and dv <= C.QVEL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("plain_pd", "meta_pd"))
@pytest.mark.parametrize("family", BIG_FAMILIES)
def test_k1d_on_card_matches_plain_version(family, mode):
    """On a CUDA card: K1d at B=64 (clip frames, seeded qvel noise) through
    gate_big against the float32 and float64 plain versions, one launch
    counted, and K2's head + tail equal to it bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    topo, env_cfg, model, lib = C.big_tree(family, "cuda",
                                           mode == "meta_pd")
    step = CS.ControlStep(topo, env_cfg, model, (2, 2))
    rng = np.random.default_rng(7)
    qpos, qvel, tb = states(lib["qpos"].cpu().numpy(), rng, 64)
    act = (0.02 * rng.standard_normal((64, step.act_dim))).astype(np.float32)
    ins = [torch.tensor(np.ascontiguousarray(x)).cuda()
           for x in (qpos, qvel, act, tb)]
    CS.reset_launches()
    out = step(*ins, 1.0)
    assert dict(CS.LAUNCHES) == {("step", topo.nbody, False): 1}
    errs, fails = C.gate_big(
        f"K1d {family} {mode}", out,
        _plain(topo, env_cfg, model, ins, torch.float32),
        _plain(topo, env_cfg, model, ins, torch.float64),
        lambda e: [C.moved_steps(topo, env_cfg, model, ins, e, dt)
                   for dt in (torch.float64, torch.float32)])
    assert not fails, (fails, errs)
    q2, v2 = K2.ControlStepSplit(topo, env_cfg, model, 2)(*ins, 1.0)
    assert torch.equal(q2, out[0]) and torch.equal(v2, out[1])
