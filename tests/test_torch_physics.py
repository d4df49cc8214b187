"""PyTorch port vs the JAX package: engine terms, blocked Cholesky and the
plain control step (the kernel's plain version) against the XLA chain."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (close, env_cfgs, jax_cfg, load_both,
                                random_states, states)
from test_torch_helpers import few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    from uhc_tpu_torch.physics.model import model_from_numpy

    return jt, jm, tt, model_from_numpy(tm, "cpu")


def _jax_terms(jt, jm, qpos, qvel):
    from uhc_tpu.physics import engine as JE

    def one(q, v):
        kin = JE.fk(jt, jm, q)
        vel = JE.velocities(jt, kin, v)
        Jl, Ja = JE.jacobians(jt, kin)
        R, s = JE.world_inertia_factors(jm, kin["xquat"])
        F, T, W = JE.contact_terms(jt, jm, kin, vel)
        Fs, Ts = JE.self_collision_terms(jt, jm, kin, vel)
        lq, ld = JE.limit_qfrc(jm, q, v)
        return dict(kin=kin, vel=vel, Jl=Jl, Ja=Ja, R=R, s=s,
                    M=JE.mass_matrix(jm, Jl, Ja, R, s),
                    C=JE.bias_force(jm, vel, Jl, Ja, R), F=F, T=T, W=W,
                    Fs=Fs, Ts=Ts, lq=lq, ld=ld)

    return jax.jit(jax.vmap(one))(jnp.asarray(qpos), jnp.asarray(qvel))


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def test_engine_terms_match_jax(setup):
    """Each engine function of the port vs uhc_tpu.physics.engine on the
    same inputs (the dynamics terms are fed the JAX side's kinematics, so
    each comparison isolates one function): ≤ 1e-5 absolute, or 1e-5
    relative where a term's entries exceed 1 (forces reach 4e3 N, where
    one float32 ulp is 2.4e-4; both sides sum in their own order)."""
    from uhc_tpu_torch.physics import engine as E

    jt, jm, tt, m = setup
    qpos, qvel = random_states(np.random.default_rng(0), 8)
    j = _jax_terms(jt, jm, qpos, qvel)
    q, v = torch.tensor(qpos), torch.tensor(qvel)
    kin = E.fk(tt, m, q)
    for k in ("xpos", "xquat", "xipos", "axes", "anchors"):
        close(j["kin"][k], kin[k], 1e-5)
    jkin, jvel = _t(j["kin"]), _t(j["vel"])
    vel = E.velocities(tt, jkin, v)
    for k in ("omega", "vel", "alpha_bias", "a_bias", "acom_bias"):
        close(j["vel"][k], vel[k], 1e-5, 1e-5)
    Jl, Ja = E.jacobians(tt, jkin)
    close(j["Jl"], Jl, 1e-5)
    close(j["Ja"], Ja, 1e-5)
    R, s = E.world_inertia_factors(m, jkin["xquat"])
    close(j["R"], R, 1e-5)
    jJl, jJa, jR = (torch.tensor(np.asarray(j[k])) for k in ("Jl", "Ja", "R"))
    close(j["M"], E.mass_matrix(m, jJl, jJa, jR, s), 1e-5, 1e-5)
    close(j["C"], E.bias_force(m, jvel, jJl, jJa, jR), 1e-5, 1e-5)
    F, T, W = E.contact_terms(tt, m, jkin, jvel)
    Fs, Ts = E.self_collision_terms(tt, m, jkin, jvel)
    lq, ld = E.limit_qfrc(m, q, v)
    for k, x in (("F", F), ("T", T), ("W", W), ("Fs", Fs), ("Ts", Ts),
                 ("lq", lq), ("ld", ld)):
        close(j[k], x, 1e-5, 1e-5)
    # the states exercise every term
    assert np.abs(np.asarray(j["Fs"])).max() > 1.0
    assert np.abs(np.asarray(j["F"])).max() > 100.0
    assert np.asarray(j["ld"]).max() > 0


def test_blocked_cholesky_inverse_matches_jax(setup):
    """blocked_cholesky + blocked_cho_solve against the identity equals
    uhc_tpu.physics.solver.exact_inverse on the stand-in's A_pd: ≤ 1e-4
    relative to the largest entry (the inverse of a system with
    cond ~1e4 carries float32 rounding of that order)."""
    from uhc_tpu.physics import solver as JS
    from uhc_tpu_torch.physics import solver as S

    jt, jm, tt, m = setup
    qpos, qvel = random_states(np.random.default_rng(1), 4)
    M = np.asarray(_jax_terms(jt, jm, qpos, qvel)["M"])
    kd = np.concatenate([np.zeros(6), np.asarray(jm.jkd)]) / 450.0
    A = (M + np.diag(kd)[None]).astype(np.float32)
    Xj = np.asarray(jax.jit(JS.exact_inverse)(jnp.asarray(A)))
    Xt = S.exact_inverse(torch.tensor(A)).numpy()
    scale = np.abs(Xj).max()
    assert np.abs(Xj - Xt).max() <= 1e-4 * scale
    # and it is an inverse
    eye = np.eye(75)[None]
    assert np.abs(A.astype(np.float64) @ Xt - eye).max() < 1e-2


@pytest.fixture(scope="module")
def frames(setup):
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)

    _, _, tt, m = setup
    lib, _ = build_expert_library(tt, m, load_motion_file(
        "sample_data/gait_clips.pkl"), max_len=40)
    return lib["qpos"].numpy()


@pytest.mark.parametrize("mode", ["plain_pd", "meta_pd"])
@pytest.mark.parametrize("schedule,jax_iters,tol_q,tol_v", [
    # same schedule: only float reassociation differs (the bounds of
    # tests/test_fused_split.py for kernel vs XLA chain)
    ((2, 2), 2, 1e-5, 1e-3),
    # the production PD-1/FD-2 schedule vs a PCG-8 solve (the bounds of
    # test_lane_kernel_schedule_variants_interpret)
    ((1, 2), 8, 2e-3, 0.2),
], ids=["pcg22_vs_pcg2", "pcg12_vs_pcg8"])
def test_control_step_reference_matches_xla_chain(setup, frames, mode,
                                                  schedule, jax_iters, tol_q,
                                                  tol_v):
    """control_step_reference over one control step vs
    uhc_tpu.physics.solver.make_do_simulation."""
    from uhc_tpu.physics import solver as JS
    from uhc_tpu_torch.physics import control_step as CS

    jt, jm, tt, m = setup
    cfg = env_cfgs()[mode]
    rng = np.random.default_rng(2)
    qpos, qvel, tb = states(frames, rng, 6)
    A = 69 + 6 + (30 if cfg.meta_pd else 0)
    act = (0.02 * rng.standard_normal((6, A))).astype(np.float32)
    sim = jax.jit(JS.make_do_simulation(jt, jax_cfg(cfg), jax_iters))
    qj, vj = sim(jm, jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(act),
                 jnp.asarray(tb), 1.0)
    qt, vt = CS.control_step_reference(
        tt, cfg, m, torch.tensor(qpos), torch.tensor(qvel), torch.tensor(act),
        torch.tensor(tb), 1.0, schedule)
    close(qj, qt, tol_q)
    close(vj, vt, tol_v)
