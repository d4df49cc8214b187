"""K2, the head/tail control step: its CUDA source compiled as host C++
(one thread per env) against its plain PyTorch version and against K1's
host build, the plain split against the one-shot plain version and the
JAX XLA chain, the K1/K2 routing, and (on a card only) the kernels."""
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (GAIT, close, env_cfgs, few_threads,
                                jax_cfg, load_both, states)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")
    lib, _ = build_expert_library(tt, m, load_motion_file(GAIT), max_len=60)
    return jt, jm, tt, m, lib["qpos"].numpy()


def _host():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from uhc_tpu_torch.csrc import build

    return build.load_host_library()


def _inputs(frames, act_dim, seed, B):
    rng = np.random.default_rng(seed)
    qpos, qvel, tb = states(frames, rng, B)
    act = (0.02 * rng.standard_normal((B, act_dim))).astype(np.float32)
    return qpos, qvel, act, tb


def _ptrs(*arrays):
    return [a.ctypes.data for a in arrays]


def _host_split(step, qpos, qvel, act, tb, rfc_rate=1.0):
    """Host build of K2: head then tail -> (qpos, qvel, X, head qpos,
    head qvel)."""
    lib = _host()
    B = qpos.shape[0]
    qm, vm = np.zeros_like(qpos), np.zeros_like(qvel)
    qo, vo = np.zeros_like(qpos), np.zeros_like(qvel)
    X = np.zeros((B, 2, 75, 75), np.float32)
    # shared model: a null seq_idx between the two tables
    tables = [step.params.ctypes.data, None, step.itab.ctypes.data]
    assert lib.uhc_control_step_head_host(
        *tables, *_ptrs(qpos, qvel, act, tb, qm, vm, X), B, act.shape[1],
        rfc_rate) == 0
    assert lib.uhc_control_step_tail_host(
        *tables, *_ptrs(qm, vm, act, tb, qo, vo, X), B, act.shape[1],
        rfc_rate) == 0
    return qo, vo, X, qm, vm


def _host_k1(step, qpos, qvel, act, tb, rfc_rate=1.0):
    lib = _host()
    qo, vo = np.zeros_like(qpos), np.zeros_like(qvel)
    assert lib.uhc_control_step_host(
        step.params.ctypes.data, None, step.itab.ctypes.data,
        *_ptrs(qpos, qvel, act, tb, qo, vo), qpos.shape[0], act.shape[1],
        rfc_rate) == 0
    return qo, vo


def _double(m):
    return type(m)(**{k: getattr(m, k).double()
                      for k in m.__dataclass_fields__})


def test_host_head_inverses_match_plain(setup):
    """The head's Xp, Xf (host build) vs the plain exact inverses of A_pd,
    A_fd at substep 0 in float64: within 1e-4 of max|X|. Both factor in
    float32 with rounding ~ cond(A)·2⁻²⁴; the reading is 2.3e-5, about
    the float32 plain version's own distance to float64."""
    from uhc_tpu_torch.physics import control_step_split as K2

    _, _, tt, m, frames = setup
    for mode, cfg in env_cfgs().items():
        step = K2.ControlStepSplit(tt, cfg, m, 2)
        qpos, qvel, act, tb = _inputs(frames, step.act_dim, 11, 8)
        _, _, X, qm, vm = _host_split(step, qpos, qvel, act, tb)
        q64, v64, X64 = K2.head_reference(
            tt, cfg, _double(m), *[torch.tensor(x).double()
                                   for x in (qpos, qvel, act, tb)], 1.0, 2)
        scale = X64.abs().amax((2, 3), keepdim=True).numpy()
        assert np.abs((X - X64.numpy()) / scale).max() <= 1e-4, mode
        # the head's own state after substep 0: bounds of the K1 host test
        close(q64, qm, 1e-5)
        close(v64, vm, 1e-3)


@pytest.mark.parametrize("mode", ["plain_pd", "meta_pd"])
@pytest.mark.parametrize("iters", [2, 3])
def test_host_split_matches_plain_and_k1(setup, mode, iters):
    """Host build, head + tail: vs the plain version at the same symmetric
    schedule within qpos 1e-5, qvel 1e-3 (the bounds of the K1 host test,
    those of tests/test_fused_split.py), and equal bit for bit to K1's host
    build at (iters, iters), the CPU analogue of test_fused_split.py:49-52
    (split vs one program)."""
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    _, _, tt, m, frames = setup
    cfg = env_cfgs()[mode]
    step = K2.ControlStepSplit(tt, cfg, m, iters)
    qpos, qvel, act, tb = _inputs(frames, step.act_dim, 12 + iters, 8)
    qo, vo, _, _, _ = _host_split(step, qpos, qvel, act, tb, 0.8)
    qr, vr = step(*[torch.tensor(x) for x in (qpos, qvel, act, tb)], 0.8)
    close(qr, qo, 1e-5)
    close(vr, vo, 1e-3)
    k1 = CS.ControlStep(tt, cfg, m, (iters, iters))
    assert np.array_equal(k1.itab, step.itab)
    q1, v1 = _host_k1(k1, qpos, qvel, act, tb, 0.8)
    np.testing.assert_array_equal(qo, q1)
    np.testing.assert_array_equal(vo, v1)


def test_plain_split_composes(setup):
    """The plain head then the plain tail equals the one-shot plain
    version (same operations in the same order)."""
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    _, _, tt, m, frames = setup
    for mode, cfg in env_cfgs().items():
        step = K2.ControlStepSplit(tt, cfg, m, 2)
        ins = [torch.tensor(x) for x in _inputs(frames, step.act_dim, 4, 5)]
        CS.reset_launches()
        q, v = step(*ins, 1.0)
        assert not CS.LAUNCHES
        qr, vr = CS.control_step_reference(tt, cfg, m, *ins, 1.0, (2, 2))
        assert torch.equal(q, qr) and torch.equal(v, vr), mode


@pytest.mark.parametrize("iters", [2, 3])
def test_plain_split_matches_xla_chain(setup, iters):
    """The port's K2 plain version vs uhc_tpu.physics.solver.
    make_do_simulation at the same PCG count: qpos 1e-5, qvel 1e-3, the
    yardstick test_fused_split.py:55 holds K2 to."""
    from uhc_tpu.physics import solver as JS
    from uhc_tpu_torch.physics import control_step_split as K2

    jt, jm, tt, m, frames = setup
    for mode, cfg in env_cfgs().items():
        step = K2.ControlStepSplit(tt, cfg, m, iters)
        qpos, qvel, act, tb = _inputs(frames, step.act_dim, 20 + iters, 6)
        sim = jax.jit(JS.make_do_simulation(jt, jax_cfg(cfg), iters))
        qj, vj = sim(jm, *[jnp.asarray(x) for x in (qpos, qvel, act, tb)],
                     1.0)
        qt, vt = step(*[torch.tensor(x) for x in (qpos, qvel, act, tb)],
                      1.0)
        close(qj, qt, 1e-5)
        close(vj, vt, 1e-3)


@pytest.mark.parametrize("lane,kind", [("0", "ControlStepSplit"),
                                       ("1", "ControlStep"),
                                       (None, "ControlStep")])
def test_routing_reads_uhc_tpu_lane(setup, monkeypatch, lane, kind):
    """make_env_step_batched(fused_model=...) builds K2 under
    UHC_TPU_LANE=0 and K1 under "1" or unset, as the JAX package routes
    (humanoid_im.py:878); without fused_model, the plain chain."""
    from uhc_tpu_torch.envs import humanoid_im as H

    _, _, tt, m, _ = setup
    if lane is None:
        monkeypatch.delenv("UHC_TPU_LANE", raising=False)
    else:
        monkeypatch.setenv("UHC_TPU_LANE", lane)
    cfg = env_cfgs()["plain_pd"]
    kernel = H.make_env_step_batched(tt, cfg, fused_model=m).kernel
    assert type(kernel).__name__ == kind
    assert kernel.pcg_iters == ((2, 2) if lane == "0" else (1, 2))
    assert H.make_env_step_batched(tt, cfg).kernel is None


def test_split_schedule_is_symmetric(setup):
    from uhc_tpu_torch.physics import control_step_split as K2

    _, _, tt, m, _ = setup
    step = K2.ControlStepSplit(tt, env_cfgs()["plain_pd"], m)
    assert step.pcg_iters == (2, 2) and step.itab[-4:-2].tolist() == [2, 2]
    assert step.itab[-1] == -1          # the v2 kernel has no refresh
    with pytest.raises(TypeError):
        K2.ControlStepSplit(tt, env_cfgs()["plain_pd"], m, (1, 2))


@pytest.mark.gpu
def test_split_on_card_matches_k1_and_plain(setup):
    """On a CUDA card: head + tail equal K1 at (2, 2) bit for bit and stay
    within qpos 1e-5 / qvel 1e-3 of the float64 plain version (see
    chip_smoke.py, which runs the same checks at B=256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2
    from uhc_tpu_torch.physics.model import model_from_numpy, model_to_numpy

    _, _, tt, m, frames = setup
    mc = model_from_numpy(model_to_numpy(m), "cuda")
    for mode, cfg in env_cfgs().items():
        step = K2.ControlStepSplit(tt, cfg, mc, 2)
        ins = [torch.tensor(x).cuda()
               for x in _inputs(frames, step.act_dim, 7, 64)]
        h0 = CS.LAUNCHES["head", 24, False]
        t0 = CS.LAUNCHES["tail", 24, False]
        q2, v2 = step(*ins, 1.0)
        assert (CS.LAUNCHES["head", 24, False],
                CS.LAUNCHES["tail", 24, False]) == (h0 + 1, t0 + 1)
        q1, v1 = CS.ControlStep(tt, cfg, mc, (2, 2))(*ins, 1.0)
        assert torch.equal(q1, q2) and torch.equal(v1, v2), mode
        q64, v64 = CS.control_step_reference(
            tt, cfg, _double(mc), *[x.double() for x in ins], 1.0, (2, 2))
        assert (q2.double() - q64).abs().max().item() <= 1e-5, mode
        assert (v2.double() - v64).abs().max().item() <= 1e-3, mode
