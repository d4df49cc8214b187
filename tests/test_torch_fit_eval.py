"""The fit-and-eval protocol against the JAX package: the per-sequence
evaluation (each clip under its own policy and running statistics) vs
uhc_tpu.learn.evaluate.make_eval_fn(per_seq_params=True); the eval CLI's
--epoch / --results-dir, --singles-dir and --dump on the repository's
uhc_implicit_dyn19 run (iter_4000.p, three per-sequence policies, the 19
clips of gait_clips_ext.pkl); cli/eval_imitation against the JAX tool on
that dump; singles files across both packages, cli/fit's included."""
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (GAIT, close, env_cfgs, few_threads,
                                jax_cfg, load_both)

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DYN19 = os.path.join(REPO, "results", "uhc_implicit_dyn19")
SINGLES = os.path.join(DYN19, "_singles")
CKPT = os.path.join(DYN19, "models", "iter_4000.p")
GAIT_EXT = "sample_data/gait_clips_ext.pkl"
FITTED = ("0-SYN_side_step", "0-SYN_walk_turn_sharp", "0-SYN_side_step_wide")
FRAMES, SEQS = 8, 3          # 7 control steps per clip
# the bounds of tests/test_torch_eval.py for the shared policy
QPOS_TOL, FIRST_STEP_TOL = 2e-2, 2e-3


def _narrow_policy(seed):
    """A seeded narrow MCP policy on obs v1 (784 -> 2 × (32, 16) -> 75)
    and running statistics around unit scale, as numpy trees."""
    from uhc_tpu_torch.learn import nets

    pol = nets.policy_mcp_init(784, 75, (32, 16), (16, 8), 2,
                               torch.Generator().manual_seed(seed), "relu",
                               "cpu")
    rng = np.random.default_rng(seed)
    rs = {"n": np.float32(50.0 + seed),
          "mean": (0.2 * rng.standard_normal(784)).astype(np.float32),
          "m2": (49.0 * (0.5 + rng.random(784))).astype(np.float32)}
    return nets.policy_to_numpy(pol), rs


@pytest.fixture(scope="module")
def per_seq_runs(tmp_path_factory):
    from uhc_tpu.data.dataset import build_expert_library as jax_build
    from uhc_tpu.data.dataset import load_motion_file as jax_load_motion
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu.learn.evaluate import make_eval_fn as jax_eval
    from uhc_tpu.smpl.constants import default_diff_weights
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file,
                                            neutral_from_library)
    from uhc_tpu_torch.learn import nets, running_norm as RN
    from uhc_tpu_torch.learn.evaluate import make_eval_fn
    from uhc_tpu_torch.physics.model import model_from_numpy

    (jt, jm), (tt, tm) = load_both(tmp_path_factory.mktemp("standin"))
    cfg = env_cfgs()["plain_pd"]
    jpw, bdw = default_diff_weights()

    def first(seqs):
        return dict(list(seqs.items())[:SEQS])

    # clip 1 runs under the base policy, clips 0 and 2 under their own
    trees = [_narrow_policy(s) for s in (11, 10, 12)]
    jlib, keys = jax_build(jt, jm, first(jax_load_motion(GAIT)),
                           max_len=FRAMES)
    steps = int(jlib["len"].max()) - 1
    nq = jlib["qpos"][0, 0]
    aux_j = {"neutral_qpos": nq, "neutral_qvel": jnp.zeros(75),
             "jpos_diffw": jnp.asarray(jpw), "body_diffw": jnp.asarray(bdw)}
    params = jax.tree.map(lambda *xs: jnp.stack(xs), *[p for p, _ in trees])
    rs_d = jax.tree.map(lambda *xs: jnp.stack(xs), *[r for _, r in trees])
    fn_j = jax_eval(jt, jax_cfg(cfg),
                    lambda p, x: JN.policy_mcp_mean(p, x, "relu"), steps,
                    fused_model=None, per_seq_params=True)
    out_j = fn_j(jm, jlib, aux_j, params,
                 JRN.RunningStats(rs_d["n"], rs_d["mean"], rs_d["m2"]))

    m = model_from_numpy(tm, "cpu")
    lib, keys_t = build_expert_library(tt, m, first(load_motion_file(GAIT)),
                                       max_len=FRAMES)
    assert keys_t == keys
    nq_t, nv_t = neutral_from_library(lib)
    aux_t = {"neutral_qpos": nq_t, "neutral_qvel": nv_t,
             "jpos_diffw": torch.tensor(jpw), "body_diffw": torch.tensor(bdw)}
    pols = [nets.policy_from_numpy(p, "relu", "cpu") for p, _ in trees]
    rss = [RN.from_numpy(r, "cpu") for _, r in trees]
    out_t = make_eval_fn(tt, cfg, nets.stack_policies(pols), steps,
                         per_seq_params=True)(m, lib, aux_t, RN.stack(rss))
    # the base policy alone, for the witness that per-sequence weights
    # are used
    out_b = make_eval_fn(tt, cfg, pols[1], steps)(m, lib, aux_t, rss[1])
    return out_j, out_t, out_b


def test_per_seq_eval_matches_jax(per_seq_runs):
    """Three clips, each under its own narrow policy and statistics (one
    of them the base's), 7 closed-loop steps: predicted qpos and joint
    positions within QPOS_TOL, the first step within FIRST_STEP_TOL, the
    same fail-safe flags, percent within 1e-6."""
    (traj_j, fs_j, pc_j), (traj_t, fs_t, pc_t), _ = per_seq_runs
    assert traj_t["pred_qpos"].shape == tuple(traj_j["pred_qpos"].shape)
    close(traj_j["pred_qpos"], traj_t["pred_qpos"], QPOS_TOL)
    close(traj_j["pred_jpos"], traj_t["pred_jpos"], QPOS_TOL)
    close(np.asarray(traj_j["pred_qpos"])[:, 0], traj_t["pred_qpos"][:, 0],
          FIRST_STEP_TOL)
    assert np.array_equal(np.asarray(fs_j), fs_t.numpy())
    close(pc_j, pc_t, 1e-6)


def test_per_seq_eval_uses_each_clips_policy(per_seq_runs):
    """Against the base policy on every clip: the clip that runs the base
    keeps its trajectory within the bounds above (the stacked forward is
    a batched matmul, rounded in another order), the two with their own
    policies leave it at the first control step."""
    _, (traj_t, _, _), (traj_b, _, _) = per_seq_runs
    gap = (traj_t["pred_qpos"] - traj_b["pred_qpos"]).abs().amax(2)
    assert gap[1, 0] <= FIRST_STEP_TOL and gap[1].max() <= QPOS_TOL
    assert bool((gap[[0, 2], 0] > 1e-3).all()), gap[:, 0]


def test_stack_policies_is_one_forward_per_row():
    """Row s of the stacked forward equals policy s's forward on that row
    (within 1e-6 + 1e-5 relative: a batched matmul in another order)."""
    from uhc_tpu_torch.learn import nets

    pols = [nets.policy_from_numpy(_narrow_policy(s)[0], "relu", "cpu")
            for s in (1, 2, 3, 4)]
    x = torch.randn(4, 784, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = nets.stack_policies(pols)(x)
        want = torch.stack([p(x[i:i + 1])[0] for i, p in enumerate(pols)])
    close(want, got, 1e-6, 1e-5)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The eval CLI on the dyn19 run at 3 control steps a clip: by
    --epoch / --results-dir, by --checkpoint, and with --singles-dir and
    --dump (stdout kept)."""
    import contextlib
    import io

    from uhc_tpu_torch.cli import eval as cli

    common = ["--motion", GAIT_EXT, "--max-seq-len", "4", "--device", "cpu"]
    by_epoch = cli.main(common + ["--results-dir", DYN19, "--epoch",
                                  "4000"])
    by_path = cli.main(common + ["--checkpoint", CKPT])
    dump = str(tmp_path_factory.mktemp("dump") / "dump.pkl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        singles = cli.main(common + ["--results-dir", DYN19, "--epoch",
                                     "4000", "--singles-dir", SINGLES,
                                     "--dump", dump])
    return by_epoch, by_path, singles, out.getvalue().splitlines(), dump


def test_eval_cli_epoch_is_the_checkpoint(cli_runs):
    """--results-dir DIR --epoch 4000 loads DIR/models/iter_4000.p:
    the same trajectories as --checkpoint, bit for bit."""
    by_epoch, by_path = cli_runs[:2]
    assert by_epoch["keys"] == by_path["keys"] and len(by_path["keys"]) == 19
    for k in ("pred_qpos", "pred_jpos"):
        assert torch.equal(by_epoch["traj"][k], by_path["traj"][k])
    assert by_epoch["summary"] == by_path["summary"]


def test_eval_cli_singles_line_and_keys(cli_runs):
    """--singles-dir prints the fitted line as the JAX CLI printed it on
    this run (results/uhc_implicit_dyn19/per_seq_eval_r5_singles.log:2),
    then 19 per-key lines and the SUMMARY. Against the base policy alone:
    the fitted clips leave its trajectory at the first control step (by
    over 1e-2), the others keep it within the bounds of
    tests/test_torch_eval.py (the stacked forward rounds in another
    order, which the closed loop amplifies)."""
    by_epoch, _, singles, lines, dump = cli_runs
    with open(os.path.join(DYN19, "per_seq_eval_r5_singles.log")) as f:
        jax_line = f.read().splitlines()[1]
    assert lines[0] == jax_line
    assert singles["fitted"] == list(FITTED)
    per_key = [ln.split(" ", 1)[0] for ln in lines[1:20]]
    assert per_key == singles["keys"]
    assert lines[20].startswith("SUMMARY ")
    assert lines[21] == f"dumped 19 sequences -> {dump}"
    gap = (singles["traj"]["pred_qpos"]
           - by_epoch["traj"]["pred_qpos"]).abs().amax(2)
    for i, key in enumerate(singles["keys"]):
        if key in FITTED:
            assert gap[i, 0] > 1e-2, key
        else:
            assert gap[i, 0] <= FIRST_STEP_TOL, key
            assert gap[i].max() <= QPOS_TOL, key


def test_dump_layout_and_eval_imitation(cli_runs, tmp_path):
    """The dump holds the JAX CLI's slicing ([:T] predicted, [1:T+1]
    reference, T = len - 1); the port's eval_imitation on it prints the
    eval's SUMMARY; the JAX eval_imitation (joblib.load, its numpy
    compute_metrics) gives the same summary, to the last bit."""
    from uhc_tpu.cli import eval_imitation as jax_tool
    from uhc_tpu_torch.cli import eval_imitation

    _, _, singles, lines, dump = cli_runs
    with open(dump, "rb") as f:
        data = pickle.load(f)
    assert list(data) == singles["keys"]
    lib = singles["lib"]
    for s, key in enumerate(singles["keys"]):
        T = int(lib["len"][s]) - 1
        d = data[key]
        assert d["pred_qpos"].shape == (T, 76) and T == 3
        assert np.array_equal(d["gt_qpos"], lib["qpos"][s, 1:T + 1].numpy())
        assert np.array_equal(d["pred_jpos"],
                              singles["traj"]["pred_jpos"][s, :T].numpy())
        assert isinstance(d["fail_safe"], bool)
    res = eval_imitation.main(["--results", dump, "--json",
                               str(tmp_path / "port.json")])
    assert res["summary"] == singles["summary"]
    assert json.loads(lines[20][len("SUMMARY "):]) == res["summary"]
    argv = sys.argv
    try:
        sys.argv = ["eval_imitation", "--results", dump, "--json",
                    str(tmp_path / "jax.json")]
        jax_tool.main()
    finally:
        sys.argv = argv
    with open(tmp_path / "jax.json") as f:
        assert json.load(f)["summary"] == res["summary"]


def test_jax_singles_load_into_the_port():
    """The repository's JAX singles (0-SYN_side_step.p): the port's policy
    and value nets and running statistics from it give the JAX functions'
    outputs on seeded observations, within 1e-5 + 1e-5 relative."""
    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.learn import nets, running_norm as RN

    d = joblib_compat.load(os.path.join(SINGLES, "0-SYN_side_step.p"))
    x = (2.0 * np.random.default_rng(0).standard_normal((4, 784))).astype(
        np.float32)
    jrs = JRN.RunningStats(*(jnp.asarray(d["running_stats"][k])
                             for k in ("n", "mean", "m2")))
    nj = JRN.normalize(jrs, jnp.asarray(x))
    nt = RN.normalize(RN.from_numpy(d["running_stats"], "cpu"),
                      torch.tensor(x))
    close(nj, nt, 1e-5, 1e-5)
    pol = nets.policy_from_numpy(d["policy_params"], "relu", "cpu")
    val = nets.value_from_numpy(d["value_params"], "relu", "cpu")
    with torch.no_grad():
        close(JN.policy_mcp_mean(d["policy_params"], nj, "relu"), pol(nt),
              1e-5, 1e-5)
        close(JN.value_apply(d["value_params"], nj, "relu"), val(nt),
              1e-5, 1e-5)
    assert np.asarray(d["log_std"]).shape == (75,)


def test_fit_writes_singles_the_jax_nets_load(tmp_path, capsys):
    """cli/fit on one clip, warm-started from a copy of iter_4000.p, one
    CPU epoch of 4 envs × 4 steps under --window-criterion: the key is
    the only one sampled, precision mode is on, the log is written, and
    the snapshot <results>/_singles/<key>.p loads into the JAX nets and
    running statistics with the port's outputs (1e-5 + 1e-5 relative) and
    differs from the warm start."""
    import shutil

    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn import running_norm as JRN
    from uhc_tpu_torch.cli import fit
    from uhc_tpu_torch.learn import running_norm as RN

    os.makedirs(tmp_path / "models")
    shutil.copy(CKPT, tmp_path / "models" / "iter_4000.p")
    key = "0-SYN_walk_turn_sharp"
    res = fit.main(["--key", key, "--motion-file", GAIT_EXT, "--epoch",
                    "4000", "--max-epochs", "1", "--succ-threshold", "0",
                    "--window-criterion", "--num-envs", "4", "--horizon",
                    "4", "--results-dir", str(tmp_path), "--device", "cpu"])
    agent = res["agent"]
    assert res["path"] == str(tmp_path / "_singles" / f"{key}.p")
    assert len(res["history"]) == 1 and res["evals"] == []
    assert agent.precision_mode and agent.epoch == 4000
    logits = agent.sampler.logits()
    assert logits[agent.seq_keys.index(key)] == 0 and (
        np.sort(logits)[-2] == -1e9)
    with open(tmp_path / "log" / "log.txt") as f:
        assert f"fit {key} epoch 4000" in f.read()
    with open(res["path"], "rb") as f:
        d = pickle.load(f)
    assert set(d) == {"policy_params", "value_params", "log_std",
                      "running_stats"}
    x = np.random.default_rng(1).standard_normal((3, 784)).astype(np.float32)
    jrs = JRN.RunningStats(*(jnp.asarray(d["running_stats"][k])
                             for k in ("n", "mean", "m2")))
    nj = JRN.normalize(jrs, jnp.asarray(x))
    close(nj, RN.normalize(agent.rs, torch.tensor(x)), 1e-5, 1e-5)
    with torch.no_grad():
        close(JN.policy_mcp_mean(d["policy_params"], nj, "relu"),
              agent.policy(torch.tensor(np.asarray(nj))), 1e-5, 1e-5)
        close(JN.value_apply(d["value_params"], nj, "relu"),
              agent.value(torch.tensor(np.asarray(nj))), 1e-5, 1e-5)
    with open(CKPT, "rb") as f:
        warm = pickle.load(f)
    assert not np.array_equal(warm["running_stats"]["mean"],
                              d["running_stats"]["mean"])
    assert np.array_equal(d["log_std"], agent.log_std.numpy())


def test_fit_full_sequence_criterion(tmp_path):
    """The protocol's stop rule on three gait clips cut to 12 frames, from
    a fresh policy: with --succ-threshold 0 and --eval-every 1 each epoch
    runs the full-sequence eval of every clip (track_best=False: no
    iter_best.p appears); the loop stops at the first eval where the key
    succeeds, else after --max-epochs."""
    from uhc_tpu_torch.cli import fit
    from uhc_tpu_torch.data.dataset import load_motion_file

    seqs = dict(list(load_motion_file(GAIT).items())[:3])
    short = {k: {f: (v[:12] if f in ("pose_aa", "trans") else v)
                 for f, v in d.items()} for k, d in seqs.items()}
    motion = tmp_path / "short.pkl"
    with open(motion, "wb") as f:
        pickle.dump(short, f)
    key = list(short)[1]
    res = fit.main(["--key", key, "--motion-file", str(motion),
                    "--max-epochs", "2", "--succ-threshold", "0",
                    "--eval-every", "1", "--num-envs", "4", "--horizon",
                    "4", "--results-dir", str(tmp_path / "run"),
                    "--device", "cpu"])
    with open(tmp_path / "run" / "log" / "log.txt") as f:
        log = f.read()
    evals = res["evals"]
    assert evals[0] == 0 and log.count("full-seq eval at epoch") == len(evals)
    # one eval per epoch run; two epochs unless the key succeeded first
    assert len(res["history"]) == len(evals)
    assert len(evals) == 2 or "full-sequence success at epoch 0" in log
    assert not os.path.exists(tmp_path / "run" / "models" / "iter_best.p")
    assert os.path.exists(res["path"])
