"""K2b, the bfloat16 preconditioner of the head/tail control step
(uhc_tpu/physics/pallas_substep.py make_fused_do_simulation with
precond_bf16=True): the plain version against the JAX kernel in interpret
mode and both against a PCG-8 XLA solve, the kernel's source built as host
C++ against its plain versions and its one-launch form, the kernels with
the flag off against the parent's arithmetic, the wrappers' buffer checks
and refusals, and the port of tools/kernel_bench.py on the CPU."""
import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import (GAIT, close, env_cfgs, few_threads, jax_cfg,
                                load_both, states)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

# The plain K2b against the JAX kernel. The flag moves a control step by
# 3.1e-5 / 3.0e-3 (qpos / qvel) on the JAX side on these states (JAX K2b
# against JAX K2), and the port's plain version by 3.2e-5 / 3.1e-3 (plain
# PD) and 5.6e-5 / 3.5e-3 (meta-PD). Both chains round to bfloat16, and
# an operand whose float32 value differs in its last bits between the two
# (another Cholesky order, another summation order) rounds to the other
# neighbour: such a split moves PCG-2's result by up to the rounding's own
# move. So the bound is of that move's size, with a margin of about 2 over
# the meta-PD move, not float32 rounding (the two packages' K2 agree to
# 3.9e-7 / 1.5e-5 on the same states).
JAX_QPOS_TOL, JAX_QVEL_TOL = 1e-4, 1e-2
# a PCG-8 solve, as tests/test_fused_split.py holds the schedules
PCG8_QPOS_TOL, PCG8_QVEL_TOL = 2e-3, 0.2
B = 8
# sha256 (first 16 hex digits) of qpos' and qvel' bytes of the host build
# of control_step.cu as it was before K2b (flag off): K1 at (1, 2) and K2
# head + tail at PCG-2, 8 states of `_inputs(..., 31)`
PARENT_DIGESTS = {"k1_plain_pd": "95b337ecebeaa772",
                  "k2_plain_pd": "b185c00e8187e4f1",
                  "k1_meta_pd": "bded3a6c0ab236df",
                  "k2_meta_pd": "380412e6953513ff"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")
    lib, _ = build_expert_library(tt, m, load_motion_file(GAIT), max_len=60)
    return jt, jm, tt, m, lib["qpos"].numpy()


def _inputs(frames, act_dim, seed, n=B):
    rng = np.random.default_rng(seed)
    qpos, qvel, tb = states(frames, rng, n)
    act = (0.02 * rng.standard_normal((n, act_dim))).astype(np.float32)
    return qpos, qvel, act, tb


def _host():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from uhc_tpu_torch.csrc import build

    return build.load_host_library(24)


def _ptrs(*arrays):
    return [a.ctypes.data for a in arrays]


def _host_run(step, entry, qpos, qvel, act, tb, bf16=False, head=None):
    """The host build's one-launch (`entry` "k1") or head + tail ("k2")
    form of `step`'s tables -> (qpos', qvel', X or None); under `bf16`
    the K2b entries, X as the bfloat16 buffer's 16-bit words. A `head`
    list receives the head's (qpos, qvel)."""
    lib, n = _host(), qpos.shape[0]
    tables = [step.params.ctypes.data, None, step.itab.ctypes.data]
    sfx = "_bf16" if bf16 else ""
    qo, vo = np.zeros_like(qpos), np.zeros_like(qvel)
    dims = (n, act.shape[1], 1.0)
    if entry == "k1":
        assert getattr(lib, f"uhc_control_step{sfx}_host")(
            *tables, *_ptrs(qpos, qvel, act, tb, qo, vo), *dims) == 0
        return qo, vo, None
    qm, vm = np.zeros_like(qpos), np.zeros_like(qvel)
    X = np.zeros((n, 2, 75, 75), np.uint16 if bf16 else np.float32)
    assert getattr(lib, f"uhc_control_step_head{sfx}_host")(
        *tables, *_ptrs(qpos, qvel, act, tb, qm, vm, X), *dims) == 0
    assert getattr(lib, f"uhc_control_step_tail{sfx}_host")(
        *tables, *_ptrs(qm, vm, act, tb, qo, vo, X), *dims) == 0
    if head is not None:
        head += [qm, vm]
    return qo, vo, X


def _double(m):
    return type(m)(**{k: getattr(m, k).double()
                      for k in m.__dataclass_fields__})


@pytest.mark.parametrize("mode", ["plain_pd", "meta_pd"])
def test_plain_k2b_matches_jax_interpret(setup, mode):
    """The plain K2b (`solver.do_simulation(..., precond_bf16=True)` at
    PCG-2) against make_fused_do_simulation(split=True, pcg_iters=2,
    precond_bf16=True) in interpret mode on 8 gait-clip states, within
    JAX_QPOS_TOL / JAX_QVEL_TOL; both within 2e-3 / 0.2 of the JAX
    package's PCG-8 XLA solve; and the flag moves the port's plain step
    (it is not K2)."""
    from uhc_tpu.physics.pallas_substep import make_fused_do_simulation
    from uhc_tpu.physics.solver import make_do_simulation
    from uhc_tpu_torch.physics import solver as S

    jt, jm, tt, m, frames = setup
    cfg = env_cfgs()[mode]
    n_act = sum(S.action_dims(tt, cfg))
    ins = _inputs(frames, n_act, 3)
    J = [jnp.asarray(x) for x in ins]
    fused = make_fused_do_simulation(jt, jax_cfg(cfg), jm, split=True,
                                     pcg_iters=2, interpret=True,
                                     precond_bf16=True)
    qj, vj = fused(*J, 1.0)
    T = [torch.tensor(x) for x in ins]
    qp, vp = S.do_simulation(tt, cfg, m, *T, 1.0, 2, precond_bf16=True)
    close(qj, qp, JAX_QPOS_TOL)
    close(vj, vp, JAX_QVEL_TOL)
    q8, v8 = make_do_simulation(jt, jax_cfg(cfg), 8)(jm, *J, 1.0)
    for q, v in ((qj, vj), (qp, vp)):
        close(q8, q, PCG8_QPOS_TOL)
        close(v8, v, PCG8_QVEL_TOL)
    qk, _ = S.do_simulation(tt, cfg, m, *T, 1.0, 2)
    assert (qk - qp).abs().max() > 1e-6


def _bf16_words(X):
    """16-bit words -> the bfloat16 values they hold, as float32."""
    return torch.from_numpy(X.astype(np.int32) << 16).view(torch.float32)


@pytest.mark.parametrize("mode", ["plain_pd", "meta_pd"])
def test_host_k2b_matches_plain_and_k1_with_the_flag(setup, mode):
    """The host build's K2b: head + tail equal bit for bit to its
    one-launch form with the flag (split=False) at (2, 2); the head's
    bfloat16 Xp/Xf equal bit for bit to the host K2 head's float32 Xp/Xf
    rounded by torch's .to(bfloat16), and within its own rounding (2⁻⁸ of
    an entry) and 1e-4 of max|X| of the float64 plain exact inverses; the
    step and the head's state held to their float32 and float64 plain
    versions given its Xp/Xf by chip_smoke.py's `gate_bf16`, as the
    kernel is on the card; the step within 2e-3 / 0.2 of the float64 PCG-8
    step."""
    import chip_smoke as C
    from uhc_tpu_torch.physics import control_step_split as K2
    from uhc_tpu_torch.physics import solver as S

    _, _, tt, m, frames = setup
    cfg = env_cfgs()[mode]
    step = K2.ControlStepSplit(tt, cfg, m, 2, precond_bf16=True)
    ins = _inputs(frames, step.act_dim, 21)
    head = []
    qo, vo, X = _host_run(step, "k2", *ins, bf16=True, head=head)
    q1, v1, _ = _host_run(step, "k1", *ins, bf16=True)
    np.testing.assert_array_equal(qo, q1)
    np.testing.assert_array_equal(vo, v1)
    _, _, X2 = _host_run(K2.ControlStepSplit(tt, cfg, m, 2), "k2", *ins)
    rne = torch.from_numpy(X2).to(torch.bfloat16).view(torch.int16)
    assert torch.equal(torch.from_numpy(X.view(np.int16)), rne)
    Xf = _bf16_words(X)
    T = [torch.tensor(x) for x in ins]
    T64 = [t.double() for t in T]
    X64 = K2.head_reference(tt, cfg, _double(m), *T64, 1.0, 2)[2]
    excess = (Xf.double() - X64).abs() - 2.0 ** -8 * X64.abs()
    assert (excess / X64.abs().amax((2, 3), keepdim=True)).max() <= 1e-4
    for part, out, stop in (("step", (qo, vo), None), ("head", head, 1)):
        errs, fails = C.gate_bf16(f"host K2b {mode} {part}",
                                  [torch.tensor(x) for x in out], Xf, tt,
                                  cfg, m, T, stop=stop)
        assert not fails, (fails, errs)
    q8, v8 = S.do_simulation(tt, cfg, _double(m), *T64, 1.0, 8)
    close(q8, qo, PCG8_QPOS_TOL)
    close(v8, vo, PCG8_QVEL_TOL)


def test_host_bf16_rounding_matches_torch():
    """K2b's rounding (`bf16_bits` of control_step.cu, one function for
    the CUDA and the host build) equals torch's .to(bfloat16) bit for bit
    on 2²⁰ seeded float32 bit patterns of every exponent, on every tie
    (low half 0x8000, even and odd) and its neighbours among them, on
    zeros, subnormals, the largest floats (which round to infinity) and
    infinities; NaN gives 0x7FC0."""
    lib = _host()
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2 ** 32, 2 ** 20, dtype=np.uint64).astype(
        np.uint32)
    ties = (bits[:4096] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    special = np.array([0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0x00008000,
                        0x00018000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000,
                        0x7F7E8000, 0x7F800000, 0xFF800000, 0x3F808000,
                        0x3F818000], np.uint32)
    x = np.concatenate([bits, ties, ties + 1, ties - 1, special]).view(
        np.float32)
    x = np.ascontiguousarray(x[~np.isnan(x)])
    out = np.zeros(x.shape, np.uint16)
    assert lib.uhc_bf16_bits_host(*_ptrs(x, out), x.size) == 0
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
    assert torch.equal(torch.from_numpy(out.view(np.int16)), want)
    nan = np.array([np.nan, -np.nan], np.float32)
    out = np.zeros(2, np.uint16)
    assert lib.uhc_bf16_bits_host(*_ptrs(nan, out), 2) == 0
    assert out.tolist() == [0x7FC0, 0x7FC0]


@pytest.mark.parametrize("mode", ["plain_pd", "meta_pd"])
def test_flag_off_keeps_the_parent_arithmetic(setup, mode):
    """With the flag off the host build gives the parent's K1 at (1, 2)
    and K2 head + tail at PCG-2 bit for bit (digests of its outputs taken
    from the source as it was before K2b), and the wrappers launch the
    same entries as before."""
    from uhc_tpu_torch.physics import control_step as CS

    _, _, tt, m, frames = setup
    cfg = env_cfgs()[mode]
    qpos, qvel, tb = states(frames, np.random.default_rng(31), B)
    for name, iters in (("k1", (1, 2)), ("k2", (2, 2))):
        step = CS.ControlStep(tt, cfg, m, iters)
        assert not step.precond_bf16
        act = (0.02 * np.random.default_rng(32).standard_normal(
            (B, step.act_dim))).astype(np.float32)
        qo, vo, _ = _host_run(step, name, qpos, qvel, act, tb)
        digest = hashlib.sha256(qo.tobytes() + vo.tobytes()).hexdigest()
        assert digest[:16] == PARENT_DIGESTS[f"{name}_{mode}"], name


def test_split_buffers_and_refusals(setup):
    """On the CPU the wrappers run the plain versions: under the flag the
    head's Xp/Xf is a (B, 2, 75, 75) torch.bfloat16 buffer holding the
    rounded plain inverses, and head + tail equal the one-launch plain
    K2b; the tail refuses a float32 buffer with the flag and a bfloat16
    one without it. The flag is refused at an asymmetric schedule, with
    explicit RFC or per-joint meta-PD, and with refresh_at."""
    from uhc_tpu_torch.config.config import EXPLICIT, META_JOINT, Config
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2
    from uhc_tpu_torch.physics import solver as S

    _, _, tt, m, frames = setup
    cfg = env_cfgs()["plain_pd"]
    k2b = K2.ControlStepSplit(tt, cfg, m, 2, precond_bf16=True)
    k2 = K2.ControlStepSplit(tt, cfg, m, 2)
    T = [torch.tensor(x) for x in _inputs(frames, k2b.act_dim, 5, 3)]
    qh, vh, X = k2b.head(*T, 1.0)
    assert X.dtype == torch.bfloat16 and tuple(X.shape) == (3, 2, 75, 75)
    X32 = K2.head_reference(tt, cfg, m, *T, 1.0, 2)[2]
    assert torch.equal(X.float(), S.round_bf16(X32))
    q, v = k2b.tail(qh, vh, T[2], T[3], X, 1.0)
    q1, v1 = CS.ControlStep(tt, cfg, m, (2, 2), precond_bf16=True)(*T, 1.0)
    assert torch.equal(q, q1) and torch.equal(v, v1)
    with pytest.raises(ValueError, match="bfloat16"):
        k2b.tail(qh, vh, T[2], T[3], X.float(), 1.0)
    with pytest.raises(ValueError, match="float32"):
        k2.tail(qh, vh, T[2], T[3], X, 1.0)
    for bad in (dict(pcg_iters=(1, 2)), dict(pcg_iters=(2, 2), refresh_at=8)):
        with pytest.raises(ValueError, match="precond_bf16"):
            CS.ControlStep(tt, cfg, m, precond_bf16=True, **bad)
    for d in (EXPLICIT, META_JOINT):
        with pytest.raises(ValueError):
            CS.ControlStep(tt, Config.from_dict("x", d).env, m, (2, 2),
                           precond_bf16=True)


def test_kernel_bench_on_cpu(capsys, monkeypatch):
    """`python -m uhc_tpu_torch.cli.kernel_bench --device cpu` at B=2,
    STEPS=1: one JSON line per row with the JAX tool's fields (build_s in
    place of compile_s), finite numbers, the TPU tiling keys listed under
    no_effect_on_card with the row's values, no kernel launch on the CPU
    and no card; an unknown key raises."""
    from uhc_tpu_torch.cli import kernel_bench

    monkeypatch.setenv("B", "2")
    monkeypatch.setenv("STEPS", "1")
    rows = ["SPLIT=1,PCG=2,BF16=1,E=16", "LANE=1,PCGPD=1,PCG=2",
            "SPLIT=0,PCG=2,BF16=1,SC=1"]
    lines = kernel_bench.main(["--device", "cpu", *rows])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert out == lines and len(lines) == len(rows)
    for line, kernel in zip(lines, ("ControlStepSplit", "ControlStep",
                                    "ControlStep")):
        assert {"cfg", "substeps_per_sec", "ms_per_ctrl_step", "build_s",
                "mean_root_z"} <= set(line)
        assert line["kernel"] == kernel and line["device"] == "cpu"
        assert line["launches"] == {} and line["card"] is None
        assert np.isfinite(line["substeps_per_sec"]) and 0.5 < line[
            "mean_root_z"] < 1.5
        assert set(line["no_effect_on_card"]) == set(
            kernel_bench.NO_EFFECT_ON_CARD)
    assert lines[0]["no_effect_on_card"]["E"] == 16
    assert "BF16=1" in lines[0]["cfg"] and "SC=1" in lines[2]["cfg"]
    with pytest.raises(ValueError, match="unknown key"):
        kernel_bench.parse_cfg("PCG=2,WARP=4")
