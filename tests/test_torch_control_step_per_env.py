"""K1e, the control-step kernel over a per-env model library: its plain
version against the JAX XLA chain on the gathered models, its CUDA source
built as host C++ against the plain version, K2's head + tail over the
same library, the equal-row library against the shared model, the
wrapper's checks and routing, and (on a card only) the kernel itself."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, env_cfgs, few_threads, jax_cfg
from test_torch_helpers import load_both

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

SHAPE = "sample_data/shape_clips.pkl"
FRAMES = 30
S_LIB = 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The stand-in on both sides and the port's shaped library of the 8
    shape clips (synthetic blendshapes), cut to FRAMES frames."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.data.dataset import (build_shaped_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data_like

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")
    lib, _, ml = build_shaped_library(
        tt, m, load_motion_file(SHAPE), synthetic_smpl_data_like(tt, m),
        Config.uhc_implicit_shape().env, max_len=FRAMES)
    return dict(jt=jt, jm=jm, tt=tt, m=m, lib=lib, ml=ml)


def _contact_library(m):
    """The shared stand-in with per-sequence contact scalars (the contact
    half of the domain-randomized library), S_LIB rows."""
    f = np.array([0.5, 1.0, 1.6, 0.8, 1.3, 0.7, 2.0, 1.1], np.float32)
    return dataclasses.replace(
        m, friction=m.friction * torch.tensor(f),
        contact_stiffness=m.contact_stiffness * torch.tensor(f[::-1].copy()),
        contact_damping=m.contact_damping * torch.tensor(np.roll(f, 3)))


def _library(s, name):
    return s["ml"] if name == "shape" else _contact_library(s["m"])


def _inputs(s, act_dim, seed, B):
    """Clip frames of every shaped sequence (its own body's FK), seeded
    qvel and actions, seq_idx spread over all S_LIB rows."""
    rng = np.random.default_rng(seed)
    seq = (np.arange(B) % S_LIB).astype(np.int32)
    rng.shuffle(seq)
    fr = rng.integers(0, FRAMES - 1, B)
    lib = s["lib"]
    qpos = np.asarray(lib["qpos"][seq, fr], np.float32)
    qvel = (0.05 * rng.standard_normal((B, 75))).astype(np.float32)
    tb = np.asarray(lib["qpos"][seq, fr + 1, 7:], np.float32)
    act = (0.02 * rng.standard_normal((B, act_dim))).astype(np.float32)
    return [torch.tensor(x) for x in (qpos, qvel, act, tb, seq)]


@pytest.mark.parametrize("library", ["shape", "contact_scalars"])
@pytest.mark.parametrize("mode", ["plain_pd", "meta_pd"])
def test_per_env_plain_chain_matches_jax(setup, library, mode):
    """control_step_reference over a model library and seq_idx vs
    uhc_tpu.physics.solver.make_do_simulation(pcg_iters=3) on the gathered
    models, at the same PCG schedule (3, 3): qpos ≤ 1e-5, qvel ≤ 1e-3
    (the bounds of tests/test_fused_split.py:228-336)."""
    from uhc_tpu.physics import solver as JS
    from uhc_tpu.physics.model import Model as JModel
    from uhc_tpu.physics.model import model_gather as jax_gather
    from uhc_tpu_torch.physics import control_step as CS

    s = setup
    cfg = env_cfgs()[mode]
    ml = _library(s, library)
    jml = JModel(**{f.name: jnp.asarray(getattr(ml, f.name).numpy())
                    for f in dataclasses.fields(ml)})
    A = 69 + 6 + (30 if cfg.meta_pd else 0)
    qpos, qvel, act, tb, seq = _inputs(s, A, 4, 8)
    sim = jax.jit(JS.make_do_simulation(s["jt"], jax_cfg(cfg), 3))
    qj, vj = sim(jax_gather(jml, jnp.asarray(seq.numpy())),
                 *(jnp.asarray(x.numpy()) for x in (qpos, qvel, act, tb)),
                 1.0)
    qt, vt = CS.control_step_reference(s["tt"], cfg, ml, qpos, qvel, act, tb,
                                       1.0, (3, 3), seq)
    close(qj, qt, 1e-5)
    close(vj, vt, 1e-3)


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


def _ptr(a):
    return None if a is None else a.ctypes.data


def _host(step, qpos, qvel, act, tb, seq, rfc_rate=1.0, part="full",
          X=None):
    """One host-build launch of K1 / K1e (part "full") or K2's head or
    tail over the step's tables; seq None passes a null seq_idx."""
    from uhc_tpu_torch.csrc import build

    lib = build.load_host_library()
    assert build.layout(lib)["params"] == step.params.shape[-1]
    ins = [np.ascontiguousarray(x.numpy(), np.float32)
           for x in (qpos, qvel, act, tb)]
    seq = None if seq is None else np.ascontiguousarray(seq.numpy(),
                                                        np.int32)
    qo, vo = np.zeros_like(ins[0]), np.zeros_like(ins[1])
    head = [_ptr(step.params), _ptr(seq), _ptr(step.itab),
            *map(_ptr, ins), _ptr(qo), _ptr(vo)]
    tail = [qpos.shape[0], act.shape[1], rfc_rate]
    if part == "full":
        assert lib.uhc_control_step_host(*head, *tail) == 0
    else:
        fn = getattr(lib, f"uhc_control_step_{part}_host")
        assert fn(*head, _ptr(X), *tail) == 0
    return qo, vo


@pytest.mark.parametrize("library", ["shape", "contact_scalars"])
@pytest.mark.parametrize("mode", ["plain_pd", "meta_pd"])
def test_k1e_source_on_host_matches_plain_version(setup, library, mode):
    """The K1e arithmetic (control_step.cu built as host C++, each env's
    model row picked by seq_idx) vs its plain version, schedule (1, 2):
    qpos ≤ 1e-5, qvel ≤ 1e-3."""
    _needs_cxx()
    from uhc_tpu_torch.physics import control_step as CS

    s = setup
    cfg = env_cfgs()[mode]
    step = CS.ControlStep(s["tt"], cfg, _library(s, library), (1, 2))
    assert step.num_models == S_LIB
    assert step.params.shape == (S_LIB, 2551)
    qpos, qvel, act, tb, seq = _inputs(s, step.act_dim, 3, 16)
    qo, vo = _host(step, qpos, qvel, act, tb, seq, 0.7)
    qr, vr = step(qpos, qvel, act, tb, 0.7, seq)     # the plain version
    assert np.abs(qo - qr.numpy()).max() <= 1e-5
    assert np.abs(vo - vr.numpy()).max() <= 1e-3
    # two bodies integrate differently from the same state: a walking
    # frame (feet on the ground) lowered 2 cm
    one = [x[:1].repeat(2, *([1] * (x.dim() - 1))) for x in
           (qpos, qvel, act, tb)]
    one[0][:] = s["lib"]["qpos"][4, 0]
    one[0][:, 2] -= 0.02
    q2, _ = _host(step, *one, torch.tensor([0, 5], dtype=torch.int32))
    assert np.abs(q2[0] - q2[1]).max() > 1e-6


@pytest.mark.parametrize("mode", ["plain_pd", "meta_pd"])
def test_host_split_over_library_equals_host_k1e(setup, mode):
    """K2's head + tail over the library (host build), at (2, 2), equal
    K1e at (2, 2) bit for bit."""
    _needs_cxx()
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit

    s = setup
    cfg = env_cfgs()[mode]
    split = ControlStepSplit(s["tt"], cfg, s["ml"], 2)
    k1e = CS.ControlStep(s["tt"], cfg, s["ml"], (2, 2))
    qpos, qvel, act, tb, seq = _inputs(s, split.act_dim, 5, 8)
    X = np.zeros((8, 2, 75, 75), np.float32)
    qh, vh = _host(split, qpos, qvel, act, tb, seq, part="head", X=X)
    q2, v2 = _host(split, torch.tensor(qh), torch.tensor(vh), act, tb, seq,
                   part="tail", X=X)
    q1, v1 = _host(k1e, qpos, qvel, act, tb, seq)
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_array_equal(v1, v2)


def test_equal_row_library_equals_shared_model(setup):
    """A library whose rows all equal the shared model gives the shared
    model's results bit for bit: the host build with seq_idx vs with a
    null one, and the plain version through the wrapper."""
    _needs_cxx()
    from uhc_tpu_torch.physics import control_step as CS

    s = setup
    m = s["m"]
    cfg = env_cfgs()["meta_pd"]
    same = dataclasses.replace(
        m, body_pos=m.body_pos.expand(S_LIB, -1, -1).clone(),
        friction=m.friction.expand(S_LIB).clone())
    shared = CS.ControlStep(s["tt"], cfg, m, (1, 2))
    lib = CS.ControlStep(s["tt"], cfg, same, (1, 2))
    np.testing.assert_array_equal(lib.params,
                                  np.broadcast_to(shared.params,
                                                  lib.params.shape))
    qpos, qvel, act, tb, seq = _inputs(s, shared.act_dim, 6, 8)
    for a, b in zip(_host(shared, qpos, qvel, act, tb, None),
                    _host(lib, qpos, qvel, act, tb, seq)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(shared(qpos, qvel, act, tb),
                    lib(qpos, qvel, act, tb, 1.0, seq)):
        assert torch.equal(a, b)


def test_seq_idx_checks(setup):
    """seq_idx out of [0, S), of another dtype or shape raises; a library
    without seq_idx and a shared model with one raise; nothing counts as
    a launch on the CPU."""
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit

    s = setup
    cfg = env_cfgs()["plain_pd"]
    step = CS.ControlStep(s["tt"], cfg, s["ml"], (1, 2))
    qpos, qvel, act, tb, seq = _inputs(s, step.act_dim, 7, 4)
    CS.reset_launches()
    for bad in (torch.tensor([0, 1, 8, 2], dtype=torch.int32),
                torch.tensor([0, -1, 3, 2], dtype=torch.int32)):
        with pytest.raises(ValueError, match="seq_idx spans"):
            step(qpos, qvel, act, tb, 1.0, bad)
        with pytest.raises(ValueError, match="seq_idx spans"):
            ControlStepSplit(s["tt"], cfg, s["ml"], 2).head(
                qpos, qvel, act, tb, 1.0, bad)
    with pytest.raises(ValueError, match="int32"):
        step(qpos, qvel, act, tb, 1.0, seq.long())
    with pytest.raises(ValueError, match="int32"):
        step(qpos, qvel, act, tb, 1.0, seq[:3])
    with pytest.raises(ValueError, match="needs seq_idx"):
        step(qpos, qvel, act, tb)
    with pytest.raises(ValueError, match="shared model"):
        CS.ControlStep(s["tt"], cfg, s["m"])(qpos, qvel, act, tb, 1.0, seq)
    assert not CS.LAUNCHES


def test_pack_tables_over_library(setup):
    """(S, P_TOTAL) rows, each the packed table of its gathered model."""
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.model import model_gather

    s = setup
    cfg = env_cfgs()["meta_pd"]
    P, I = CS.pack_tables(s["tt"], cfg, s["ml"])
    assert P.shape == (S_LIB, 2551) and I.shape == (235,)
    for r in (0, 3, 7):
        Pr, Ir = CS.pack_tables(s["tt"], cfg, model_gather(s["ml"], r))
        np.testing.assert_array_equal(P[r], Pr)
        np.testing.assert_array_equal(I, Ir)
    assert not np.array_equal(P[0], P[2])


def test_env_step_routes_library_to_k1e(setup):
    """A model library routes make_env_step_batched to ControlStep over
    the library (K2 over it under UHC_TPU_LANE=0); leaves outside the
    per-env set are refused; on the CPU the routed step equals the plain
    chain over the gathered models."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit

    s = setup
    cfg = Config.uhc_implicit_shape().env
    step = H.make_env_step_batched(s["tt"], cfg, fused_model=s["ml"])
    assert step.kernel.num_models == S_LIB
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UHC_TPU_LANE", "0")
        k2 = H.make_env_step_batched(s["tt"], cfg, fused_model=s["ml"])
        assert isinstance(k2.kernel, ControlStepSplit)
        assert k2.kernel.num_models == S_LIB
    bad = dataclasses.replace(s["ml"],
                              jkp=s["ml"].jkp.expand(S_LIB, -1).clone())
    with pytest.raises(ValueError, match="jkp"):
        H.make_env_step_batched(s["tt"], cfg, fused_model=bad)


@pytest.mark.gpu
def test_k1e_on_card_matches_plain_version(setup):
    """On a CUDA card: K1e vs its plain version in float64, and the
    launch counted as K1e (chip_smoke.py runs the same check at B=256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.model import model_from_numpy, model_to_numpy

    s = setup
    mc = model_from_numpy(model_to_numpy(s["ml"]), "cuda")
    m64 = type(mc)(**{f.name: getattr(mc, f.name).double()
                      for f in dataclasses.fields(mc)})
    for mode, cfg in env_cfgs().items():
        step = CS.ControlStep(s["tt"], cfg, mc, (1, 2))
        qpos, qvel, act, tb, seq = [x.cuda() for x in
                                    _inputs(s, step.act_dim, 8, 64)]
        n0 = CS.LAUNCHES["step", 24, True]
        qk, vk = step(qpos, qvel, act, tb, 1.0, seq)
        assert CS.LAUNCHES["step", 24, True] == n0 + 1
        q64, v64 = CS.control_step_reference(
            s["tt"], cfg, m64, *[x.double() for x in (qpos, qvel, act, tb)],
            1.0, (1, 2), seq)
        assert (qk.double() - q64).abs().max().item() <= 1e-5, mode
        assert (vk.double() - v64).abs().max().item() <= 1e-3, mode
