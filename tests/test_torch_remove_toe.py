"""remove_toe's 22-body tree on the control-step kernels: the port's plain
step against the JAX lane kernel in interpret mode and the JAX XLA chain,
the control-step source built as host C++ with -DNB=22 against its plain
version (K1, K1f, K2's head and tail, K1e over a 2-model library), the
env's routing on the tree, a 3-step batched rollout against the JAX
package, and (on a card only) the kernels themselves. Both packages build
the tree from the stand-in loaded by their own MJCF loaders; the gait
clips reach it through each package's SMPLConverter. Inputs are clip
frames with seeded noise, made with numpy."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (GAIT, close, env_cfgs, few_threads, jax_cfg,
                                load_both, states)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

B = 16
FRAMES = 30
# the bounds of tests/test_fused_split.py: kernel vs chain at one schedule
QPOS_TOL, QVEL_TOL = 1e-5, 1e-3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both packages' remove_toe trees of the stand-in, their converters
    from the 24-body tree and their expert libraries of the gait clips
    (FRAMES frames)."""
    from uhc_tpu.data.dataset import build_expert_library as jax_library
    from uhc_tpu.data.dataset import load_motion_file as jax_motion
    from uhc_tpu.smpl.converter import SMPLConverter as JConverter
    from uhc_tpu.smpl.local_robot import remove_toe_model as jax_remove_toe
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.converter import SMPLConverter
    from uhc_tpu_torch.smpl.local_robot import remove_toe_model

    (jt24, jm24), (tt24, tm24) = load_both(tmp_path_factory.mktemp("standin"))
    jt, jm = jax_remove_toe(jt24, jm24)
    tt, tm = remove_toe_model(tt24, tm24)
    jconv, conv = JConverter(jt24, jt), SMPLConverter(tt24, tt)
    m = model_from_numpy(tm, "cpu")
    root = np.asarray(tm24.body_pos)[0]
    lib, keys = build_expert_library(tt, m, load_motion_file(GAIT),
                                     converter=conv, base_root_offset=root,
                                     max_len=FRAMES)
    jlib, jkeys = jax_library(jt, jm, jax_motion(GAIT), converter=jconv,
                              base_root_offset=root, max_len=FRAMES)
    assert keys == jkeys
    return dict(jt=jt, jm=jm, tt=tt, m=m, lib=lib, jlib=jlib, conv=conv,
                jconv=jconv)


def _inputs(s, cfg, seed, n=B):
    from uhc_tpu_torch.physics import solver as S

    rng = np.random.default_rng(seed)
    qpos, qvel, tb = states(s["lib"]["qpos"].numpy(), rng, n)
    act = 0.02 * rng.standard_normal((n, sum(S.action_dims(s["tt"], cfg))))
    return [torch.tensor(np.ascontiguousarray(x, np.float32))
            for x in (qpos, qvel, act, tb)]


def test_tree_and_tables(setup):
    """22 bodies (nq 70, nv 69), depth-first, the ankles leaves; the int
    table of the -DNB=22 layout (29 self-collision pairs, J6 / G rows by
    subtree); the model fits the kernel's contact tables."""
    from uhc_tpu_torch.csrc import build
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.smpl.constants import self_collision_pairs

    s = setup
    t = s["tt"]
    assert (t.nbody, t.nq, t.nv) == (22, 70, 69)
    assert t.parents == s["jt"].parents and t.body_names == s["jt"].body_names
    end = t.subtree_end()
    for side in ("L", "R"):
        a = t.body_names.index(f"{side}_Ankle")
        assert end[a] == a + 1
    assert len(self_collision_pairs(t)) == 29 <= CS.MAXPAIR
    cfg = env_cfgs()["plain_pd"]
    P, I = CS.pack_tables(t, cfg, s["m"], (1, 2))
    jrow, jcol, jpair = CS.jacobian_tables(t)
    # each body's J6 rows: 6 + 3·depth columns; every (body, dof) pair with
    # the dof above the body once
    anc = t.ancestor_mask()
    assert np.array_equal(np.diff(jrow)[::6], anc.sum(1).astype(int))
    assert len(jpair) == int(anc.sum())
    if shutil.which("g++") or shutil.which("c++"):
        lay = build.layout(build.load_host_library(22))
        assert (lay["nbody"], lay["params"], lay["itab"]) == (22, P.size,
                                                              I.size)
        assert lay["workspace"] == 0


def test_plain_step_matches_jax_lane_kernel_and_xla_chain(setup):
    """The port's plain step on the 22-body tree, 16 envs, meta-PD with
    self-collision: at PCG (1, 2) against the JAX lane kernel in
    interpret mode (env_tile 16, sub_tile 8, the production routing's
    pcg_vpu), and at PCG (3, 3) against the JAX XLA chain
    (solver.make_do_simulation at 3): qpos 1e-5, qvel 1e-3."""
    from uhc_tpu.physics import solver as JS
    from uhc_tpu.physics.pallas_lane import make_fused_do_simulation_lane
    from uhc_tpu_torch.physics import control_step as CS

    s = setup
    cfg = env_cfgs()["meta_pd"]
    assert cfg.self_collision
    ins = _inputs(s, cfg, 1)
    jins = [jnp.asarray(x.numpy()) for x in ins]
    fn = make_fused_do_simulation_lane(
        s["jt"], jax_cfg(cfg), s["jm"], env_tile=16, sub_tile=8,
        pcg_iters=(1, 2), interpret=True, pcg_vpu=True)
    qj, vj = fn(*jins, 1.0)
    qt, vt = CS.control_step_reference(s["tt"], cfg, s["m"], *ins, 1.0,
                                       (1, 2))
    close(qj, qt, QPOS_TOL)
    close(vj, vt, QVEL_TOL)
    sim = jax.jit(JS.make_do_simulation(s["jt"], jax_cfg(cfg), 3))
    qx, vx = sim(s["jm"], *jins, 1.0)
    q3, v3 = CS.control_step_reference(s["tt"], cfg, s["m"], *ins, 1.0,
                                       (3, 3))
    close(qx, q3, QPOS_TOL)
    close(vx, v3, QVEL_TOL)


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


def _ptr(a):
    return None if a is None else a.ctypes.data


def _host(step, ins, seq=None, part="full"):
    """One launch of the -DNB=22 host build with the step's tables: K1 /
    K1e / K1f ("full") or K2's head and then tail ("split", which also
    returns the head's state)."""
    from uhc_tpu_torch.csrc import build
    from uhc_tpu_torch.physics import control_step as CS

    lib = build.load_host_library(22)
    qpos, qvel, act, tb = [np.ascontiguousarray(x.numpy()) for x in ins]
    seq = None if seq is None else np.ascontiguousarray(seq.numpy(),
                                                        np.int32)
    tables = [_ptr(step.params), _ptr(seq), _ptr(step.itab)]
    tail = [len(qpos), step.act_dim, 1.0]
    qo, vo = np.zeros_like(qpos), np.zeros_like(qvel)
    if part == "split":
        X = np.zeros((len(qpos), 2, 69, 69), np.float32)
        qm, vm = np.zeros_like(qpos), np.zeros_like(qvel)
        assert lib.uhc_control_step_head_host(
            *tables, *map(_ptr, (qpos, qvel, act, tb, qm, vm, X)),
            *tail) == 0
        assert lib.uhc_control_step_tail_host(
            *tables, *map(_ptr, (qm, vm, act, tb, qo, vo, X)), *tail) == 0
        return [torch.tensor(a) for a in (qo, vo, qm, vm)]
    if step.k1f:
        vfx, gains = CS.k1f_operands(step.topo, step.cfg,
                                     step.model_on("cpu"), ins[2])
        ops = [None if x is None else np.ascontiguousarray(x.numpy())
               for x in (vfx, gains)]
        assert lib.uhc_control_step_f_host(
            *tables, *map(_ptr, (qpos, qvel, act, tb, qo, vo)),
            *map(_ptr, ops), *tail) == 0
    else:
        assert lib.uhc_control_step_host(
            *tables, *map(_ptr, (qpos, qvel, act, tb, qo, vo)), *tail) == 0
    return [torch.tensor(a) for a in (qo, vo)]


def _mass_library(m):
    """Two remove_toe models that differ only in body_mass."""
    return dataclasses.replace(m, body_mass=torch.stack(
        [m.body_mass, m.body_mass * 1.3]))


@pytest.mark.parametrize("kernel", ["k1", "k1_meta_pd", "k1f_explicit",
                                    "k1f_meta_joint", "k2", "k1e"])
def test_host_build_matches_plain_version(setup, kernel):
    """The -DNB=22 host build against the port's plain version at the
    route's schedule, 16 envs: K1 at (1, 2) with plain PD and meta-PD,
    K1f under explicit RFC and per-joint meta-PD at (1, 2), K2's head and
    tail at PCG-2 (the head's state against the plain head too), K1e over
    a 2-model library at (1, 2): qpos 1e-5, qvel 1e-3."""
    _needs_cxx()
    from uhc_tpu_torch.config.config import EXPLICIT, META_JOINT, Config
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    s = setup
    cfg = {"k1_meta_pd": env_cfgs()["meta_pd"],
           "k1f_explicit": Config.from_dict("explicit", EXPLICIT).env,
           "k1f_meta_joint": Config.from_dict("meta_joint", META_JOINT).env
           }.get(kernel, env_cfgs()["plain_pd"])
    model = _mass_library(s["m"]) if kernel == "k1e" else s["m"]
    ins = _inputs(s, cfg, 7)
    seq = (torch.arange(B, dtype=torch.int32) % 2 if kernel == "k1e"
           else None)
    if kernel == "k2":
        step = K2.ControlStepSplit(s["tt"], cfg, model, 2)
        qo, vo, qm, vm = _host(step, ins, part="split")
        qh, vh, _ = K2.head_reference(s["tt"], cfg, model, *ins, 1.0, 2)
        close(qh, qm, QPOS_TOL)
        close(vh, vm, QVEL_TOL)
        pcg = (2, 2)
    else:
        step = CS.ControlStep(s["tt"], cfg, model, (1, 2))
        assert step.k1f == kernel.startswith("k1f")
        assert (step.num_models == 2) == (kernel == "k1e")
        qo, vo = _host(step, ins, seq)
        pcg = (1, 2)
    qr, vr = CS.control_step_reference(s["tt"], cfg, model, *ins, 1.0, pcg,
                                       seq)
    close(qr, qo, QPOS_TOL)
    close(vr, vo, QVEL_TOL)


def test_env_routes_remove_toe_like_jax(setup, monkeypatch):
    """make_env_step_batched on the 22-body tree takes the JAX package's
    small-tree lane route: K1 at (1, 2), K1f for explicit RFC, K1e over a
    library, K2 at PCG-2 under UHC_TPU_LANE=0; JAX asks for its lane
    kernel at (1, 2) there, and for its head/tail kernel under
    UHC_TPU_LANE=0."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.physics import pallas_lane as JPL
    from uhc_tpu.physics import pallas_substep as JPS
    from uhc_tpu_torch.config.config import EXPLICIT, Config
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics.control_step import ControlStep
    from uhc_tpu_torch.physics.control_step_split import ControlStepSplit

    s = setup
    cfg = env_cfgs()["plain_pd"]
    seen = []
    monkeypatch.setattr(JPL, "make_fused_do_simulation_lane",
                        lambda *a, **kw: seen.append(("lane", kw)))
    monkeypatch.setattr(JPS, "make_fused_do_simulation",
                        lambda *a, **kw: seen.append(("split", kw)))
    JH.make_env_step_batched(s["jt"], jax_cfg(cfg), fused_model=s["jm"])
    k = H.make_env_step_batched(s["tt"], cfg, fused_model=s["m"]).kernel
    assert type(k) is ControlStep and k.pcg_iters == (1, 2)
    assert seen[-1][0] == "lane" and seen[-1][1]["pcg_iters"] == (1, 2)
    kx = H.make_env_step_batched(
        s["tt"], Config.from_dict("explicit", EXPLICIT).env,
        fused_model=s["m"]).kernel
    assert type(kx) is ControlStep and kx.k1f
    ke = H.make_env_step_batched(s["tt"], cfg,
                                 fused_model=_mass_library(s["m"])).kernel
    assert type(ke) is ControlStep and ke.num_models == 2
    monkeypatch.setenv("UHC_TPU_LANE", "0")
    JH.make_env_step_batched(s["jt"], jax_cfg(cfg), fused_model=s["jm"])
    k2 = H.make_env_step_batched(s["tt"], cfg, fused_model=s["m"]).kernel
    assert type(k2) is ControlStepSplit and k2.pcg_iters == (2, 2)
    assert seen[-1][0] == "split" and seen[-1][1]["pcg_iters"] == 2


HORIZON = 3


def test_rollout_matches_jax(setup):
    """Three steps of 8 envs on the 22-body tree with a small Gaussian
    policy, the mean action, eval-mode resets, unit running stats, the
    converter's diff weights and plain PCG-5 physics on both sides,
    against uhc_tpu.learn.rollout, at the bounds of the uhc_implicit
    rollout test (tests/test_torch_train.py): obs 2e-4, bootstrap obs
    4e-2, actions 1e-4, rewards 5e-6, final qpos 1e-3."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu.learn.rollout import make_rollout_fn as jax_rollout
    from uhc_tpu_torch.data.dataset import neutral_from_library
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.rollout import make_rollout_fn
    from uhc_tpu_torch.physics import solver as S

    s = setup
    cfg = env_cfgs()["plain_pd"]
    lib, tt = s["lib"], s["tt"]
    D, A, n = H.obs_dim(tt, cfg), sum(S.action_dims(tt, cfg)), 8
    pol = nets.policy_gaussian_init(D, A, (64, 32),
                                    torch.Generator().manual_seed(8),
                                    "gelu", "cpu")
    jpw = s["conv"].get_new_diff_weight().astype(np.float32)
    assert np.array_equal(jpw, s["jconv"].get_new_diff_weight()
                          .astype(np.float32))
    nq, nv = neutral_from_library(lib)
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.tensor(jpw),
           "body_diffw": torch.tensor(jpw[1:])}
    aux_j = {"neutral_qpos": jnp.asarray(nq.numpy()),
             "neutral_qvel": jnp.asarray(nv.numpy()),
             "jpos_diffw": jnp.asarray(jpw), "body_diffw": jnp.asarray(jpw[1:])}
    seq, start = np.arange(n) % 6, np.array([0, 4, 9, 2, 1, 5, 3, 7])
    jcfg = jax_cfg(cfg)
    fn = jax.jit(jax_rollout(
        s["jt"], jcfg, lambda p, x: JN.policy_gaussian_mean(p, x, "gelu"),
        HORIZON, fused_model=None))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jst = jax.vmap(lambda k, q, st: JH.env_reset(
        s["jt"], s["jm"], jcfg, k, q, s["jlib"], aux_j["neutral_qpos"],
        aux_j["neutral_qvel"], start_ind=st, train=False))(
        keys, jnp.asarray(seq, jnp.int32), jnp.asarray(start, jnp.int32))
    rsj0 = JRN.RunningStats(jnp.asarray(2.0), jnp.zeros(D), jnp.ones(D))
    sj, rsj, trj, lastj = fn(s["jm"], s["jlib"], aux_j,
                             nets.policy_to_numpy(pol), jnp.full(A, -2.3),
                             rsj0, jst, jax.random.PRNGKey(1), 0.0, 1.0,
                             jnp.zeros(6))
    st0 = H.env_reset(tt, s["m"], cfg, torch.tensor(seq), lib, nq, nv,
                      start_ind=torch.tensor(start), train=False)
    rst0 = RN.RunningStats(torch.tensor(2.0), torch.zeros(D), torch.ones(D))
    st, rst, trt, lastt = make_rollout_fn(tt, cfg, pol, HORIZON)(
        s["m"], lib, aux, torch.full((A,), -2.3), rst0, st0,
        torch.Generator().manual_seed(0), 0.0, 1.0, torch.zeros(6))
    assert not np.asarray(trj.dones).any() and not trt.dones.any()
    close(trj.states, trt.states, 2e-4)
    close(lastj, lastt, 4e-2)
    close(trj.actions, trt.actions, 1e-4)
    close(trj.rewards, trt.rewards, 5e-6)
    close(sj.qpos, st.qpos, 1e-3)
    assert st.qpos.shape == (n, 70) and bool(torch.isfinite(st.qpos).all())


@pytest.mark.gpu
def test_kernels_on_card_match_plain_version(setup):
    """On a CUDA card: K1-22 at (1, 2), K2-22 head + tail at PCG-2 (equal
    to K1-22 at (2, 2) bit for bit) and K1e-22 over the 2-model library,
    against their float64 plain versions at the kernel bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2
    from uhc_tpu_torch.physics.model import model_from_numpy, model_to_numpy

    s = setup
    cfg = env_cfgs()["meta_pd"]
    dev = torch.device("cuda")
    m = model_from_numpy(model_to_numpy(s["m"]), dev)
    lib = _mass_library(m)
    ins = [x.to(dev) for x in _inputs(s, cfg, 3, 64)]
    seq = (torch.arange(64, dtype=torch.int32) % 2).to(dev)

    def plain64(model, pcg, sq=None):
        m64 = type(model)(**{f.name: getattr(model, f.name).double()
                             for f in dataclasses.fields(model)})
        return CS.control_step_reference(
            s["tt"], cfg, m64, *[x.double() for x in ins], 1.0, pcg, sq)

    for out, ref in (
            (CS.ControlStep(s["tt"], cfg, m, (1, 2))(*ins, 1.0),
             plain64(m, (1, 2))),
            (CS.ControlStep(s["tt"], cfg, lib, (1, 2))(*ins, 1.0, seq),
             plain64(lib, (1, 2), seq))):
        assert (out[0].double() - ref[0]).abs().max() <= QPOS_TOL
        assert (out[1].double() - ref[1]).abs().max() <= QVEL_TOL
    split = K2.ControlStepSplit(s["tt"], cfg, m, 2)
    qh, vh, X = split.head(*ins, 1.0)
    q2, v2 = split.tail(qh, vh, ins[2], ins[3], X, 1.0)
    q1, v1 = CS.ControlStep(s["tt"], cfg, m, (2, 2))(*ins, 1.0)
    assert torch.equal(q1, q2) and torch.equal(v1, v2)
