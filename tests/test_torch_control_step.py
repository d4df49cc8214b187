"""K1, the control-step kernel: its CUDA source compiled as host C++ (one
thread per env) against its plain PyTorch version, the wrapper's routing
and input checks, and (on a card only) the kernel itself."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from test_torch_helpers import GAIT, env_cfgs, states
from test_torch_helpers import few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


@pytest.fixture(scope="module")
def setup():
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    topo, mnp = load_fixture_humanoid()
    m = model_from_numpy(mnp, "cpu")
    lib, _ = build_expert_library(topo, m, load_motion_file(GAIT),
                                  max_len=60)
    return topo, m, lib["qpos"].numpy()


def _inputs(frames, step, seed, B):
    rng = np.random.default_rng(seed)
    qpos, qvel, tb = states(frames, rng, B)
    act = (0.02 * rng.standard_normal((B, step.act_dim))).astype(np.float32)
    return [torch.tensor(x) for x in (qpos, qvel, act, tb)]


def _run_host(step, qpos, qvel, act, tb, rfc_rate=1.0):
    from uhc_tpu_torch.csrc import build

    lib = build.load_host_library()
    lay = build.layout(lib)
    assert (lay["params"], lay["itab"]) == (step.params.size,
                                            step.itab.size)
    P = np.ascontiguousarray(step.params, np.float32)
    I = np.ascontiguousarray(step.itab, np.int32)
    ins = [np.ascontiguousarray(x.numpy(), np.float32)
           for x in (qpos, qvel, act, tb)]
    qo, vo = np.zeros_like(ins[0]), np.zeros_like(ins[1])
    rc = lib.uhc_control_step_host(
        P.ctypes.data, None, I.ctypes.data, *[x.ctypes.data for x in ins],
        qo.ctypes.data, vo.ctypes.data, qpos.shape[0], act.shape[1],
        rfc_rate)
    assert rc == 0
    return qo, vo


@pytest.mark.parametrize("mode", ["plain_pd", "meta_pd"])
def test_kernel_source_on_host_matches_plain_version(setup, mode):
    """The kernel's arithmetic (csrc/control_step.cu built as host C++)
    vs control_step_reference over one control step, schedule (1, 2):
    qpos ≤ 1e-5, qvel ≤ 1e-3 (the kernel-vs-XLA bounds of
    tests/test_fused_split.py)."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from uhc_tpu_torch.physics import control_step as CS

    topo, m, frames = setup
    cfg = env_cfgs()[mode]
    step = CS.ControlStep(topo, cfg, m, (1, 2))
    qpos, qvel, act, tb = _inputs(frames, step, 3, 8)
    qo, vo = _run_host(step, qpos, qvel, act, tb, 0.7)
    qr, vr = CS.control_step_reference(topo, cfg, m, qpos, qvel, act, tb,
                                       0.7, (1, 2))
    assert np.abs(qo - qr.numpy()).max() <= 1e-5
    assert np.abs(vo - vr.numpy()).max() <= 1e-3


def test_kernel_source_self_collision_and_limits(setup):
    """Stress states with self-collisions and joint-limit hits: host build
    vs plain version at schedule (2, 2)."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from test_torch_helpers import random_states
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import engine as E

    topo, m, _ = setup
    cfg = env_cfgs()["plain_pd"]
    step = CS.ControlStep(topo, cfg, m, (2, 2))
    rng = np.random.default_rng(0)
    qpos, qvel = random_states(rng, 8)
    qpos[:, 2] = 1.2        # airborne: no ground contact, only body terms
    qvel *= 0.1
    tb = qpos[:, 7:].copy()
    act = (0.02 * rng.standard_normal((8, step.act_dim))).astype(np.float32)
    qpos, qvel, act, tb = (torch.tensor(x) for x in (qpos, qvel, act, tb))
    kin = E.fk(topo, m, qpos)
    Fs, _ = E.self_collision_terms(topo, m, kin,
                                   E.velocities(topo, kin, qvel))
    assert Fs.abs().max() > 1.0
    assert E.limit_qfrc(m, qpos, qvel)[1].max() > 0
    qo, vo = _run_host(step, qpos, qvel, act, tb)
    qr, vr = CS.control_step_reference(topo, cfg, m, qpos, qvel, act, tb,
                                       1.0, (2, 2))
    assert np.abs(qo - qr.numpy()).max() <= 1e-5
    assert np.abs(vo - vr.numpy()).max() <= 1e-3


def test_wrapper_runs_plain_version_on_cpu(setup):
    from uhc_tpu_torch.physics import control_step as CS

    topo, m, frames = setup
    cfg = env_cfgs()["plain_pd"]
    step = CS.ControlStep(topo, cfg, m)
    qpos, qvel, act, tb = _inputs(frames, step, 5, 4)
    CS.reset_launches()
    q1, v1 = step(qpos, qvel, act, tb, 1.0)
    q2, v2 = CS.control_step_reference(topo, cfg, m, qpos, qvel, act, tb)
    assert torch.equal(q1, q2) and torch.equal(v1, v2)
    assert not CS.LAUNCHES           # only kernel launches count


def test_pack_tables_layout(setup):
    from uhc_tpu_torch.physics import control_step as CS

    topo, m, _ = setup
    cfg = env_cfgs()["meta_pd"]
    P, I = CS.pack_tables(topo, cfg, m, (1, 2))
    assert P.dtype == np.float32 and I.dtype == np.int32
    assert P.size == 2551 and I.size == 1428
    # schedule, flags and the refresh substep (none) end the int table
    assert I[-8:].tolist() == [1, 1, 1, 1, 1, 2, 15, -1]
    # levels cover every non-root body once
    assert sorted(I[48:71].tolist()) == list(range(1, 24))
    with pytest.raises(ValueError, match="torque"):
        CS.pack_tables(topo, dataclasses.replace(cfg, action_type="torque"),
                       m)


def test_wrapper_rejects_bad_inputs(setup):
    from uhc_tpu_torch.physics import control_step as CS

    topo, m, frames = setup
    step = CS.ControlStep(topo, env_cfgs()["plain_pd"], m)
    qpos, qvel, act, tb = _inputs(frames, step, 6, 2)
    with pytest.raises(ValueError):
        step.check_inputs(qpos, qvel, act[:, :10], tb)
    with pytest.raises(TypeError):
        step.check_inputs(qpos.double(), qvel, act, tb)
    with pytest.raises(ValueError):
        step.check_inputs(qpos, qvel.t().contiguous().t(), act, tb)


def test_control_step_flops_counts_contacts(setup):
    from uhc_tpu_torch.physics import control_step as CS

    topo, _, _ = setup
    cfg = env_cfgs()["plain_pd"]
    none = [np.zeros((2, 24), bool)] * 15
    feet = [np.zeros((2, 24), bool) for _ in range(15)]
    for a in feet:
        a[:, [3, 4, 7, 8]] = True
    f0 = CS.control_step_flops(topo, cfg, none)
    f1 = CS.control_step_flops(topo, cfg, feet)
    assert 1e6 < f0 / 2 < 1e7 and f1 > f0


@pytest.mark.gpu
def test_kernel_on_card_matches_plain_version(setup):
    """On a CUDA card: the kernel vs its plain version in float64 (see
    chip_smoke.py, which runs the same check at B=256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.model import model_from_numpy, model_to_numpy

    topo, m, frames = setup
    mc = model_from_numpy(model_to_numpy(m), "cuda")
    m64 = type(mc)(**{f.name: getattr(mc, f.name).double()
                      for f in dataclasses.fields(mc)})
    for mode, cfg in env_cfgs().items():
        step = CS.ControlStep(topo, cfg, mc, (1, 2))
        ins = [x.cuda() for x in _inputs(frames, step, 7, 64)]
        n0 = CS.LAUNCHES["step", 24, False]
        qk, vk = step(*ins, 1.0)
        assert CS.LAUNCHES["step", 24, False] == n0 + 1
        q64, v64 = CS.control_step_reference(
            topo, cfg, m64, *[x.double() for x in ins], 1.0, (1, 2))
        assert (qk.double() - q64).abs().max().item() <= 1e-5, mode
        assert (vk.double() - v64).abs().max().item() <= 1e-3, mode
