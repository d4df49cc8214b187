"""K1g, the lane kernel's options: `refresh_at` (a second exact inverse
pair at substep k), `cond_inv` (the inverse pair under a run-time branch)
and `merge_j6` (one contraction for every wrench projection). The port's
plain chain with the refresh against the JAX lane kernel with all three
options in interpret mode; the control-step source built as host C++
with the refresh against its plain version on the 24-body tree and on
SMPL-H; the operation count of the refresh; and UHC_TPU_MERGEJ6=1 routing
to the same kernel the JAX package asks for. Inputs are clip frames of
the gait clips with seeded noise, made with numpy."""
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as C
from test_torch_helpers import (GAIT, big_env_cfg, big_trees, close,
                                env_cfgs, few_threads, jax_cfg, load_both,
                                states)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

B = 8
REFRESH = C.REFRESH_AT


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The stand-in on both sides and the port's expert library of the
    gait clips."""
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")
    lib, _ = build_expert_library(tt, m, load_motion_file(GAIT), max_len=30)
    return dict(jt=jt, jm=jm, tt=tt, m=m, lib=lib)


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


def _inputs(lib, topo, cfg, seed, n=B):
    """Clip-frame states and seeded actions as float32 tensors."""
    from uhc_tpu_torch.physics import solver as S

    rng = np.random.default_rng(seed)
    qpos, qvel, tb = states(lib["qpos"].numpy(), rng, n)
    act = (0.02 * rng.standard_normal((n, sum(S.action_dims(topo, cfg)))))
    return [torch.tensor(np.ascontiguousarray(x, np.float32))
            for x in (qpos, qvel, act, tb)]


def _host(step, ins):
    """One launch of the host build of K1 / K1d with the step's tables."""
    from uhc_tpu_torch.csrc import build

    lib = build.load_host_library(step.topo.nbody)
    assert build.layout(lib)["itab"] == step.itab.size
    arrs = [np.ascontiguousarray(x.numpy()) for x in ins]
    out = [np.zeros_like(arrs[0]), np.zeros_like(arrs[1])]
    assert lib.uhc_control_step_host(
        step.params.ctypes.data, None, step.itab.ctypes.data,
        *[a.ctypes.data for a in arrs + out], len(arrs[0]), step.act_dim,
        1.0) == 0
    return [torch.tensor(a) for a in out]


def test_plain_refresh_matches_jax_lane_kernel_interpret(setup):
    """The port's plain chain at PCG (1, 1) with refresh_at=8 against
    uhc_tpu.physics.pallas_lane.make_fused_do_simulation_lane in interpret
    mode at the same schedule with refresh_at=8, cond_inv=True and
    merge_j6=True (bench.py's meta-PD config, 8 envs): qpos 1e-5, qvel
    1e-3, the kernel-vs-chain bounds of tests/test_fused_split.py. The
    same chain without the refresh is more than 1e-5 away in qpos, so the
    comparison sees the refresh."""
    from uhc_tpu.physics.pallas_lane import make_fused_do_simulation_lane
    from uhc_tpu_torch.physics import control_step as CS

    s = setup
    cfg = env_cfgs()["meta_pd"]
    ins = _inputs(s["lib"], s["tt"], cfg, 1)
    fn = make_fused_do_simulation_lane(
        s["jt"], jax_cfg(cfg), s["jm"], env_tile=8, sub_tile=8,
        pcg_iters=(1, 1), interpret=True, pcg_vpu=True, refresh_at=REFRESH,
        cond_inv=True, merge_j6=True)
    qj, vj = fn(*(jnp.asarray(x.numpy()) for x in ins), 1.0)
    qt, vt = CS.control_step_reference(s["tt"], cfg, s["m"], *ins, 1.0,
                                       (1, 1), refresh_at=REFRESH)
    close(qj, qt, 1e-5)
    close(vj, vt, 1e-3)
    qu, _ = CS.control_step_reference(s["tt"], cfg, s["m"], *ins, 1.0,
                                      (1, 1))
    assert np.abs(np.asarray(qj) - qu.numpy()).max() > 1e-5


@pytest.mark.parametrize("tree", ["smpl_24", "smplh"])
def test_host_refresh_matches_plain_version(setup, tmp_path, tree):
    """The control-step source built as host C++ with the refresh
    (I_REFRESH = 8) against its plain version on 16 clip-frame envs: K1 at
    (1, 1) on the 24-body tree, K1d at (2, 2) on SMPL-H, through
    chip_smoke's `gate_big` at qpos 1e-5, qvel 1e-3 (one PCG iteration
    per solve spreads float32 results across the bounds on some envs, as
    the card's check found; the gate holds such an env to a witness).
    Without the refresh the host build lands more than 1e-5 away in qpos,
    so the build does not drop it."""
    _needs_cxx()
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.model import model_from_numpy

    if tree == "smplh":
        _, (topo, mnp, _) = big_trees(tmp_path)["smplh"]
        m = model_from_numpy(mnp, "cpu")
        lib, _ = build_expert_library(topo, m, load_motion_file(GAIT),
                                      max_len=20)
        cfg, pcg = big_env_cfg("smplh"), (2, 2)
    else:
        topo, m, lib = setup["tt"], setup["m"], setup["lib"]
        cfg, pcg = env_cfgs()["plain_pd"], (1, 1)
    step = CS.ControlStep(topo, cfg, m, pcg, refresh_at=REFRESH)
    assert step.itab[-1] == REFRESH
    ins = _inputs(lib, topo, cfg, 2, n=16)
    out = _host(step, ins)
    plain32, plain64 = C.plain_pair(topo, cfg, m, ins, pcg, REFRESH)
    errs, fails = C.gate_big(
        f"host K1g {tree}", out, plain32, plain64,
        lambda e: [C.moved_steps(topo, cfg, m, ins, e, dt, pcg_iters=pcg,
                                 refresh_at=REFRESH)
                   for dt in (torch.float64, torch.float32)])
    assert not fails, (fails, errs["kernel_missed_envs"])
    unrefreshed = _host(CS.ControlStep(topo, cfg, m, pcg), ins)
    assert (unrefreshed[0] - out[0]).abs().max().item() > 1e-5


def test_flops_count_the_refresh(setup):
    """control_step_flops counts one more exact inverse pair with the
    refresh (two n×n Cholesky inverses, 2·2·(n³/3 + n³/6 + n³/6) per env),
    also when K2's tail alone is counted from substep 1, and none for a
    refresh at substep 0, which has its pair already."""
    from uhc_tpu_torch.physics import control_step as CS

    topo, cfg = setup["tt"], env_cfgs()["plain_pd"]
    n, nv = 3, topo.nv
    act = [np.zeros((n, topo.nbody), bool)] * 15
    pair = n * 2 * 2.0 * (nv ** 3 / 3 + nv ** 3 / 6 + nv ** 3 / 6)
    base = CS.control_step_flops(topo, cfg, act, (1, 1))
    assert CS.control_step_flops(topo, cfg, act, (1, 1),
                                 refresh_at=REFRESH) == pytest.approx(
        base + pair, rel=1e-12)
    assert CS.control_step_flops(topo, cfg, act, (1, 1),
                                 refresh_at=0) == base
    tail = CS.control_step_flops(topo, cfg, act[1:], (1, 1), start=1)
    assert CS.control_step_flops(topo, cfg, act[1:], (1, 1), start=1,
                                 refresh_at=REFRESH) == pytest.approx(
        tail + pair, rel=1e-12)


def test_refresh_in_tables_and_wrappers(setup):
    """refresh_at goes into the int table's last slot (-1 without it),
    must name a substep in [1, frame_skip), is counted under its own
    launch key on a card only, and K2 keeps -1 (the v2 kernel has no
    refresh)."""
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit

    topo, m, cfg = setup["tt"], setup["m"], env_cfgs()["meta_pd"]
    assert CS.pack_tables(topo, cfg, m, (1, 1))[1][-1] == -1
    assert CS.pack_tables(topo, cfg, m, (1, 1), REFRESH)[1][-1] == REFRESH
    for bad in (0, 15, -1):
        with pytest.raises(ValueError, match="refresh_at"):
            CS.ControlStep(topo, cfg, m, (1, 1), refresh_at=bad)
    assert ControlStepSplit(topo, cfg, m).itab[-1] == -1
    step = CS.ControlStep(topo, cfg, m, (1, 1), refresh_at=REFRESH)
    CS.reset_launches()
    ins = _inputs(setup["lib"], topo, cfg, 3, n=2)
    q, v = step(*ins, 1.0)          # CPU tensors: the plain version
    q2, v2 = CS.control_step_reference(topo, cfg, m, *ins, 1.0, (1, 1),
                                       refresh_at=REFRESH)
    assert torch.equal(q, q2) and torch.equal(v, v2)
    assert not CS.LAUNCHES
    assert C.COUNTERS["k1g"] == ("step_refresh", 24, False)


def test_mergej6_routes_to_the_same_kernel(setup, monkeypatch):
    """UHC_TPU_MERGEJ6=1 makes the JAX package build its lane kernel with
    merge_j6=True (read by replacing the builder with a recorder); the
    port routes to the same ControlStep, tables and schedule included, as
    without it: the CUDA kernel already projects every body's wrenches in
    one pass (uhc_implicit, explicit and meta_joint on the 24-body
    tree)."""
    import uhc_tpu.physics.pallas_lane as JPL
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.envs import humanoid_im as H

    s = setup
    seen = []
    monkeypatch.setattr(JPL, "make_fused_do_simulation_lane",
                        lambda *a, **k: seen.append(k))
    monkeypatch.delenv("UHC_TPU_LANE", raising=False)
    modes = C.k1f_modes()
    for cfg in (env_cfgs()["plain_pd"], modes["explicit"],
                modes["meta_joint"]):
        kernels = {}
        for merge in ("0", "1"):
            monkeypatch.setenv("UHC_TPU_MERGEJ6", merge)
            seen.clear()
            JH.make_env_step_batched(s["jt"], jax_cfg(cfg),
                                     fused_model=s["jm"])
            (kw,) = seen
            assert kw["merge_j6"] == (merge == "1")
            kernels[merge] = H.make_env_step_batched(
                s["tt"], cfg, fused_model=s["m"]).kernel
        a, b = kernels["0"], kernels["1"]
        assert type(a) is type(b) and a.pcg_iters == b.pcg_iters == (1, 2)
        assert np.array_equal(a.params, b.params)
        assert np.array_equal(a.itab, b.itab) and a.k1f == b.k1f
        assert a.refresh_at is None and b.refresh_at is None
