"""The shape-conditioned slice against the JAX package: synthetic SMPL
blendshapes, per-shape models, the shaped and domain-randomized libraries,
LBS and the vertex metrics, obs v2 with the shape observation, a short
uhc_implicit_shape rollout, the shape agent on the CPU and the trained
shape checkpoint carried across. The control step over a model library
is tested in tests/test_torch_control_step_per_env.py."""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, few_threads, jax_cfg, load_both

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = "sample_data/shape_clips.pkl"
GAIT = "sample_data/gait_clips.pkl"
SHAPE_CKPT = os.path.join(REPO, "results", "uhc_implicit_shape_r4", "models",
                          "iter_1000.p")
FRAMES = 20
SHAPE_LEAVES = {"body_pos", "body_ipos", "body_mass", "body_inertia",
                "contact_point", "sc_point", "sc_radius"}


def _shape_cfg():
    from uhc_tpu_torch.config.config import Config

    return Config.uhc_implicit_shape()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The stand-in on both sides, with each side's synthetic SMPL data
    and its shaped library of the 8 shape clips cut to FRAMES frames."""
    from uhc_tpu.data.dataset import build_shaped_library as jax_shaped
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu.smpl.lbs import synthetic_smpl_data_like as jax_like
    from uhc_tpu_torch.data.dataset import (build_shaped_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data_like

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    m = model_from_numpy(tm, "cpu")
    cfg = _shape_cfg().env
    jsd, sd = jax_like(jt, jm), synthetic_smpl_data_like(tt, m)
    jlib, jkeys, jml = jax_shaped(jt, jm, jax_load_motion(SHAPE), jsd,
                                  jax_cfg(cfg), max_len=FRAMES)
    lib, keys, ml = build_shaped_library(tt, m, load_motion_file(SHAPE), sd,
                                         cfg, max_len=FRAMES)
    assert keys == jkeys
    return dict(jt=jt, jm=jm, jsd=jsd, jlib=jlib, jml=jml, tt=tt, m=m,
                sd=sd, lib=lib, ml=ml, cfg=cfg)


def _seq_betas():
    from uhc_tpu_torch.data.dataset import load_motion_file, seq_beta_gender

    return [seq_beta_gender(d)[0]
            for d in load_motion_file(SHAPE).values()]


@pytest.mark.parametrize("kind", ["like_standin", "random"])
def test_synthetic_smpl_data_equals_jax_exactly(both, kind):
    """Pure numpy from the same seed on both sides: bit-equal arrays."""
    from uhc_tpu.smpl import lbs as JL
    from uhc_tpu_torch.smpl import lbs as L

    if kind == "like_standin":
        j, t = both["jsd"], both["sd"]
    else:
        j, t = JL.synthetic_smpl_data(3, V=64), L.synthetic_smpl_data(3, V=64)
    for f in ("v_template", "shapedirs", "j_regressor", "weights"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy())
    np.testing.assert_array_equal(JL.vertex_body_assignment(j),
                                  L.vertex_body_assignment(t))


def test_model_from_betas_matches_jax(both):
    """Each of the 8 clips' bodies: every shape leaf within 1e-6 of its
    largest entry (float32 blendshape sums in another order), the
    anatomical joint ranges equal."""
    from uhc_tpu.smpl import lbs as JL
    from uhc_tpu.smpl import robot as JR
    from uhc_tpu_torch.smpl import lbs as L
    from uhc_tpu_torch.smpl import robot as R

    s = both
    ja, ta = JL.vertex_body_assignment(s["jsd"]), L.vertex_body_assignment(
        s["sd"])
    for b in _seq_betas():
        j = JR.model_from_betas(s["jt"], s["jm"], s["jsd"], jnp.asarray(b),
                                ja)
        t = R.model_from_betas(s["tt"], s["m"], s["sd"], b, ta)
        for f in SHAPE_LEAVES:
            a = np.asarray(getattr(j, f))
            err = np.abs(a - getattr(t, f).numpy()).max() / np.abs(a).max()
            assert err <= 1e-6, (f, err)
    np.testing.assert_array_equal(
        np.asarray(JR.rel_joint_ranges(s["jt"], s["jm"])),
        R.rel_joint_ranges(s["tt"], s["m"]).numpy())
    lib = R.batched_models(s["tt"], s["m"], s["sd"], np.stack(_seq_betas()),
                           ta)
    assert lib.body_pos.shape == (8, 24, 3) and lib.jkp.ndim == 1


def test_shaped_library_matches_jax(both):
    """qpos and wbpos within 1e-5; shape_obs, len, beta and gender exact;
    height_lb within 1e-5; the same leaves carry the library dim, and the
    per-sequence models agree within 1e-6 of each leaf's largest entry."""
    from uhc_tpu.physics.model import model_batch_axes as jax_axes
    from uhc_tpu_torch.physics.model import model_batch_axes

    s = both
    jlib, lib = s["jlib"], s["lib"]
    close(jlib["qpos"], lib["qpos"], 1e-5)
    close(jlib["wbpos"], lib["wbpos"], 1e-5)
    for k in ("shape_obs", "len", "beta", "gender"):
        np.testing.assert_array_equal(np.asarray(jlib[k]), lib[k].numpy())
    close(jlib["height_lb"], lib["height_lb"], 1e-5)
    close(jlib["weight"], lib["weight"], 1e-5, 1e-6)
    ja = jax_axes(s["jml"])
    batched = {k for k, a in model_batch_axes(s["ml"]).items() if a == 0}
    jbatched = {f.name for f in dataclasses.fields(s["jml"])
                if getattr(ja, f.name) == 0}
    assert batched == jbatched == SHAPE_LEAVES
    for k in batched:
        a = np.asarray(getattr(s["jml"], k))
        err = np.abs(a - getattr(s["ml"], k).numpy()).max() / np.abs(a).max()
        assert err <= 1e-6, (k, err)
    # each clip's root sits at its trans plus its own body's root offset
    from uhc_tpu_torch.data.dataset import load_motion_file

    trans0 = np.stack([np.asarray(d["trans"][0], np.float32)
                       for d in load_motion_file(SHAPE).values()])
    close(trans0 + s["ml"].body_pos[:, 0].numpy(), lib["qpos"][:, 0, :3],
          1e-6)


def test_dr_library_matches_jax(both):
    """The same seed gives the same factors: contact scalars, masses and
    inertias bit-equal, keys and tiling equal."""
    from uhc_tpu.data.dataset import build_dr_library as jax_dr
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu_torch.data.dataset import build_dr_library, load_motion_file

    s = both
    jlib, jkeys, jml = jax_dr(s["jt"], s["jm"], jax_load_motion(GAIT), 4,
                              seed=5, max_len=10)
    lib, keys, ml = build_dr_library(s["tt"], s["m"], load_motion_file(GAIT),
                                     4, seed=5, max_len=10)
    assert keys == jkeys and len(keys) == 24
    for k in ("friction", "contact_stiffness", "contact_damping",
              "body_mass", "body_inertia"):
        np.testing.assert_array_equal(np.asarray(getattr(jml, k)),
                                      getattr(ml, k).numpy())
    assert ml.friction.shape == (24,) and ml.body_pos.ndim == 2
    np.testing.assert_array_equal(np.asarray(jlib["len"]), lib["len"].numpy())
    close(jlib["qpos"], lib["qpos"], 1e-5)


def test_lbs_and_vertex_metrics_match_jax(both):
    """qpos_to_smpl, LBS, vertices_from_qpos within 1e-5 of the JAX
    package; vertex penetration and skate (mm) within 1e-3 relative on a
    clip lowered 3 cm into the floor."""
    from uhc_tpu.learn import metrics as JM
    from uhc_tpu.smpl import convert as JC
    from uhc_tpu.smpl import lbs as JL
    from uhc_tpu_torch.learn import metrics as M
    from uhc_tpu_torch.smpl import convert as C
    from uhc_tpu_torch.smpl import lbs as L

    s = both
    rng = np.random.default_rng(7)
    pose = (0.4 * rng.standard_normal((5, 24, 3))).astype(np.float32)
    trans = rng.standard_normal((5, 3)).astype(np.float32)
    beta = _seq_betas()[5]
    jv, jj = jax.vmap(lambda p, t: JL.lbs(s["jsd"], p, jnp.asarray(beta),
                                          t))(pose, trans)
    tv, tj = L.lbs(s["sd"], pose, beta, trans)
    close(jv, tv, 1e-5)
    close(jj, tj, 1e-5)

    qpos = s["lib"]["qpos"][5].numpy().copy()
    qpos[:, 2] -= 0.03
    ro = s["ml"].body_pos[5, 0].numpy()
    ja, jt = JC.qpos_to_smpl(jnp.asarray(qpos), jnp.asarray(ro))
    ta, tt_ = C.qpos_to_smpl(qpos, ro)
    close(ja, ta, 1e-5)
    close(jt, tt_, 1e-6)
    jverts = JM.vertices_from_qpos(qpos, s["jsd"], beta, ro)
    verts = M.vertices_from_qpos(qpos, s["sd"], beta, ro)
    close(jverts, verts, 1e-5)
    jm = JM.compute_penetration_skate_vertices(jverts)
    tm = M.compute_penetration_skate_vertices(verts)
    assert jm["penetration"] > 1.0
    for k in ("penetration", "skate"):
        close(jm[k], tm[k], 1e-4, 1e-3)


def _states(s, B, seed):
    """The same env states on both sides over the shaped library: clip
    frames + seeded noise, every sequence used."""
    from uhc_tpu.envs.humanoid_im import EnvState as JState
    from uhc_tpu_torch.envs.humanoid_im import EnvState, get_body_quat

    lib = s["lib"]
    rng = np.random.default_rng(seed)
    seq = np.arange(B) % 8
    start = rng.integers(0, 5, B)
    cur = rng.integers(1, 8, B)
    fr = start + cur
    qpos = np.asarray(lib["qpos"][seq, fr], np.float32).copy()
    qpos[:, 7:] += 0.05 * rng.standard_normal((B, 69))
    qvel = (np.asarray(lib["qvel"][seq, fr])
            + 0.1 * rng.standard_normal((B, 75))).astype(np.float32)
    prev = np.asarray(lib["qpos"][seq, fr - 1], np.float32)
    t = torch.tensor
    port = EnvState(
        qpos=t(qpos), qvel=t(qvel), prev_qpos=t(prev), cur_t=t(cur),
        start_ind=t(start), seq_idx=t(seq),
        prev_bquat=get_body_quat(t(prev)),
        done=torch.zeros(B, dtype=torch.bool),
        fail=torch.zeros(B, dtype=torch.bool),
        end=torch.zeros(B, dtype=torch.bool), percent=torch.zeros(B))
    i32 = lambda x: jnp.asarray(x, jnp.int32)             # noqa: E731
    jst = JState(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
        prev_qpos=jnp.asarray(prev), cur_t=i32(cur), start_ind=i32(start),
        seq_idx=i32(seq), prev_bquat=jnp.asarray(port.prev_bquat.numpy()),
        done=jnp.zeros(B, bool), fail=jnp.zeros(B, bool),
        end=jnp.zeros(B, bool), percent=jnp.zeros(B),
        rng=jnp.zeros((B, 2), jnp.uint32))
    return jst, port


def test_obs_v2_with_shape_obs_matches_jax(both):
    """obs v2 + the 17-wide shape observation (657 wide) over the model
    library vs uhc_tpu get_obs_batched: within 1e-4 (the bound of the obs
    v1 test), the shape block exact."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu_torch.envs import humanoid_im as H

    s = both
    jst, port = _states(s, 16, 1)
    cfg = s["cfg"]
    oj = JH.get_obs_batched(s["jt"], s["jml"], jax_cfg(cfg), jst, s["jlib"])
    ot = H.get_obs(s["tt"], s["ml"], cfg, port, s["lib"])
    assert ot.shape == (16, 657) == (16, H.obs_dim(s["tt"], cfg))
    close(oj, ot, 1e-4)
    np.testing.assert_array_equal(np.asarray(oj)[:, -17:],
                                  ot[:, -17:].numpy())
    bare = {k: v for k, v in s["lib"].items() if k != "shape_obs"}
    with pytest.raises(ValueError, match="shape_obs"):
        H.get_obs(s["tt"], s["ml"], cfg, port, bare)


HORIZON = 3


def test_shape_rollout_matches_jax(both):
    """Three steps of 8 envs (one per shaped body) of uhc_implicit_shape
    with a small Gaussian gelu policy, the mean action, eval-mode resets,
    unit running stats and plain PCG-5 physics on both sides, against
    uhc_tpu.learn.rollout, at the bounds of the uhc_implicit rollout test
    (tests/test_torch_train.py): obs 2e-4, bootstrap obs 4e-2, actions
    1e-4, rewards 5e-6, final qpos 1e-3."""
    from uhc_tpu.envs import humanoid_im as JH
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu.learn.rollout import make_rollout_fn as jax_rollout
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.data.dataset import neutral_from_library
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.rollout import make_rollout_fn

    s = both
    cfg, lib = s["cfg"], s["lib"]
    D, A, B = H.obs_dim(s["tt"], cfg), 105, 8
    pol = nets.policy_gaussian_init(D, A, (64, 32),
                                    torch.Generator().manual_seed(8),
                                    "gelu", "cpu")
    jpw, bdw = default_diff_weights()
    nq, nv = neutral_from_library(lib)
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    aux_j = {"neutral_qpos": jnp.asarray(nq.numpy()),
             "neutral_qvel": jnp.zeros(75), "jpos_diffw": jnp.asarray(jpw),
             "body_diffw": jnp.asarray(bdw)}
    seq, start = np.arange(B), np.array([0, 4, 9, 2, 1, 5, 3, 7])
    jcfg = jax_cfg(cfg)
    fn = jax.jit(jax_rollout(
        s["jt"], jcfg, lambda p, x: JN.policy_gaussian_mean(p, x, "gelu"),
        HORIZON, fused_model=None))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jst = jax.vmap(lambda k, q, st: JH.env_reset(
        s["jt"], s["jml"], jcfg, k, q, s["jlib"], aux_j["neutral_qpos"],
        aux_j["neutral_qvel"], start_ind=st, train=False))(
        keys, jnp.asarray(seq, jnp.int32), jnp.asarray(start, jnp.int32))
    rsj0 = JRN.RunningStats(jnp.asarray(2.0), jnp.zeros(D), jnp.ones(D))
    sj, rsj, trj, lastj = fn(s["jml"], s["jlib"], aux_j,
                             nets.policy_to_numpy(pol), jnp.full(A, -2.3),
                             rsj0, jst, jax.random.PRNGKey(1), 0.0, 1.0,
                             jnp.zeros(8))
    st0 = H.env_reset(s["tt"], s["ml"], cfg, torch.tensor(seq), lib,
                      nq, nv, start_ind=torch.tensor(start), train=False)
    rst0 = RN.RunningStats(torch.tensor(2.0), torch.zeros(D), torch.ones(D))
    st, rst, trt, lastt = make_rollout_fn(s["tt"], cfg, pol, HORIZON)(
        s["ml"], lib, aux, torch.full((A,), -2.3), rst0, st0,
        torch.Generator().manual_seed(0), 0.0, 1.0, torch.zeros(8))
    assert not np.asarray(trj.dones).any() and not trt.dones.any()
    np.testing.assert_array_equal(np.asarray(trj.masks), trt.masks.numpy())
    close(trj.states, trt.states, 2e-4)
    close(lastj, lastt, 4e-2)
    close(trj.actions, trt.actions, 1e-4)
    close(trj.rewards, trt.rewards, 5e-6)
    close(sj.qpos, st.qpos, 1e-3)
    assert float(rsj.n) == float(rst.n) == 2 + B * HORIZON


@pytest.fixture(scope="module")
def shape_agent(tmp_path_factory):
    """Two CPU epochs of the uhc_implicit_shape agent at full width, 4
    envs × 4 steps on the shape clips cut to FRAMES frames, a minibatch of
    8 rows."""
    from uhc_tpu_torch.learn.agent import CopycatAgent

    cfg = dataclasses.replace(_shape_cfg(), mini_batch_size=8,
                              num_optim_epoch=2)
    with pytest.warns(UserWarning, match="synthetic"):
        agent = CopycatAgent(cfg, SHAPE, num_envs=4, horizon=4, seed=3,
                             max_seq_len=FRAMES,
                             results_dir=str(tmp_path_factory.mktemp("run")),
                             device="cpu")
    return agent, [agent.optimize_policy(i) for i in range(2)]


def test_shape_agent_two_cpu_epochs(shape_agent):
    """Finite stats, the value loss falling across each update, the
    library simulated (8 bodies) and a 657 → 105 Gaussian policy."""
    from uhc_tpu_torch.learn.nets import PolicyGaussian
    from uhc_tpu_torch.physics.model import model_is_batched

    agent, stats = shape_agent
    assert isinstance(agent.policy, PolicyGaussian)
    assert (agent.obs_dim, agent.action_dim) == (657, 105)
    assert model_is_batched(agent.sim_model)
    assert agent.sim_model.body_pos.shape == (8, 24, 3)
    for st in stats:
        for k, v in st.items():
            assert np.all(np.isfinite(v)), (k, v)
        assert st["value_loss"] < st["value_loss_before"]
    res = agent.eval_policy(track_best=False)
    assert {"penetration", "skate"} <= set(res["summary"])
    assert np.isfinite(res["summary"]["penetration"])


def test_gaussian_checkpoint_reads_in_both_packages(shape_agent):
    """The shape agent's checkpoint through uhc_tpu.learn.nets and back
    through the port: policy mean and value within 1e-5."""
    from uhc_tpu.learn import nets as JN
    from uhc_tpu_torch.learn import nets

    agent, _ = shape_agent
    with open(agent.save_checkpoint(2), "rb") as f:
        ck = pickle.load(f)
    x = np.random.default_rng(0).standard_normal((6, 657)).astype(
        np.float32)
    with torch.no_grad():
        mean_t = agent.policy(torch.tensor(x)).numpy()
        val_t = agent.value(torch.tensor(x)).numpy()
        back = nets.policy_from_numpy(ck["policy_params"], "gelu", "cpu")
        assert torch.equal(back(torch.tensor(x)), torch.tensor(mean_t))
    close(JN.policy_gaussian_mean(ck["policy_params"], x, "gelu"), mean_t,
          1e-5, 1e-5)
    close(JN.value_apply(ck["value_params"], x, "relu"), val_t, 1e-5, 1e-5)


def test_shape_checkpoint_eval_cli_matches_jax_policy(capsys):
    """cli/eval --cfg uhc_implicit_shape on the trained JAX checkpoint (8
    clips, 8 frames, CPU) runs and prints its summary; the policy it
    loaded gives uhc_tpu.learn.nets.policy_gaussian_mean's means on the
    same observations within 1e-5."""
    from uhc_tpu.learn import nets as JN
    from uhc_tpu_torch.cli import eval as cli_eval
    from uhc_tpu_torch.data import joblib_compat

    res = cli_eval.main(["--cfg", "uhc_implicit_shape", "--motion", SHAPE,
                         "--checkpoint", SHAPE_CKPT, "--device", "cpu",
                         "--max-seq-len", "8"])
    out = capsys.readouterr().out
    assert "SUMMARY" in out and res["summary"]["num_seqs"] == 8
    assert np.isfinite(res["summary"]["mpjpe"])
    assert np.isfinite(res["summary"]["penetration"])
    ck = joblib_compat.load(SHAPE_CKPT)
    rs = ck["running_stats"]
    x = (np.asarray(rs["mean"]) + np.random.default_rng(2).standard_normal(
        (6, 657))).astype(np.float32)
    with torch.no_grad():
        mean_t = res["policy"](torch.tensor(x)).numpy()
    close(JN.policy_gaussian_mean(ck["policy_params"], jnp.asarray(x),
                                  "gelu"), mean_t, 1e-5, 1e-5)
