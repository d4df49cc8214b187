"""The kinematic-policy CLIs of the port: two CPU epochs of
`cli/train --cfg uhm_1 --agent uhm` at full width and small B, and
`cli/eval_relive` of the repository's trained kin checkpoint
(results/uhm_1/models/iter_0100.p) with its frozen copycat
(results/uhc_implicit/models/iter_best.p) over 2 gait clips against the
JAX package's eval_relive.main (its UHMAgent given the stand-in through a
subclass, its native mesh toolkit off, the port's library handed to it),
bounded as the copycat eval's parity is (tests/test_torch_eval.py:83)."""
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from test_torch_helpers import close, few_threads, jax_library

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

GAIT = "sample_data/gait_clips.pkl"
KIN_CKPT = "results/uhm_1/models/iter_0100.p"
CC_CKPT = "results/uhc_implicit/models/iter_best.p"
# tests/test_torch_eval.py's bound of a closed loop in float32
QPOS_TOL = 2e-2
MAX_LEN = 8
METRICS = ("succ", "mpjpe", "pa_mpjpe", "mpjpe_g", "root_dist", "vel_dist",
           "accel_dist")


def test_train_cli_uhm_two_epochs(tmp_path, capsys):
    """--cfg uhm_1 --agent uhm: two epochs of 4 envs × 3 steps (RL and the
    supervised update), finite stats, the checkpoint at 2 reloading to the
    same kin net and value net bit for bit, the log lines."""
    from uhc_tpu_torch.cli import train
    from uhc_tpu_torch.learn import kin_net as KN
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.data import joblib_compat

    out = str(tmp_path / "run")
    agent, hist = train.main(["--cfg", "uhm_1", "--agent", "uhm", "--device",
                              "cpu", "--num-envs", "4", "--horizon", "3",
                              "--epochs", "2", "--max-seq-len", "12",
                              "--results-dir", out])
    assert len(hist) == 2 and agent.total_epochs == 2
    for st in hist:
        for k in ("reward_mean", "supervised_loss", "episodes", "T_total"):
            assert np.isfinite(st[k]), k
    ck = joblib_compat.load(agent.checkpoint_path(2))
    assert ck["epoch"] == 2
    same = KN.kin_net_to_numpy(agent.net)
    for (a, b) in zip(*(np.concatenate([np.ravel(x) for x in
                                        _leaves(t)]) for t in
                        (ck["params"], same))):
        assert a == b
    x = torch.randn((3, 640), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(nets.value_from_numpy(ck["value_params"], "relu",
                                                 "cpu")(x), agent.value(x))
    log = capsys.readouterr().out
    assert "agent uhm, kin obs_dim=640 cc obs_dim=784" in log
    assert "epoch 1: R=" in log and "sup=" in log
    assert "saved checkpoint @ 2" in log


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_eval_relive_matches_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs on a copy of iter_0100.p with iter_best.p's copycat, the
    first 2 gait clips cut to 8 frames: the dumped predicted qpos within
    QPOS_TOL (2e-2, the float32 closed loop's bound), the GT frames equal,
    the JSON's keys and coverage equal, every metric within 1 mm + 2 %."""
    import uhc_tpu.cli.eval_relive as JE
    import uhc_tpu.learn.agent_uhm as JA
    import uhc_tpu.native.meshtools as native
    from uhc_tpu_torch.cli import eval_relive
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import (load_fixture_humanoid,
                                                     write_fixture_humanoid)

    seqs = load_motion_file(GAIT)
    two = {k: seqs[k] for k in list(seqs)[:2]}
    data = str(tmp_path / "two.pkl")
    with open(data, "wb") as f:
        pickle.dump(two, f)
    runs = {}
    for side in ("port", "jax"):
        runs[side] = str(tmp_path / side)
        os.makedirs(os.path.join(runs[side], "models"))
        shutil.copy(KIN_CKPT, os.path.join(runs[side], "models"))
    args = ["--epoch", "100", "--cc-checkpoint", CC_CKPT, "--data", data,
            "--max-seq-len", str(MAX_LEN)]

    res = eval_relive.main(["--cfg", "uhm_1", "--device", "cpu",
                            "--results-dir", runs["port"], "--dump",
                            str(tmp_path / "port.pkl")] + args)
    assert res["control_steps"] == MAX_LEN - 1

    topo, model = load_fixture_humanoid()
    lib, keys = build_expert_library(topo, model_from_numpy(model, "cpu"),
                                     two, max_len=MAX_LEN)
    xml = write_fixture_humanoid(str(tmp_path / "xml"))

    class StandIn(JA.UHMAgent):
        def __init__(self, *a, **k):
            super().__init__(*a, model_xml=xml, **k)

    monkeypatch.setattr(JA, "UHMAgent", StandIn)
    monkeypatch.setattr(JA, "build_expert_library", lambda *a, **k: (
        jax_library(lib), list(keys)))
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr("sys.argv", ["eval_relive", "--cfg", "uhm_1",
                                     "--results-dir", runs["jax"], "--dump",
                                     str(tmp_path / "jax.pkl")] + args)
    JE.main()
    capsys.readouterr()

    with open(os.path.join(runs["jax"], "eval_relive_0100.json")) as f:
        want = json.load(f)
    with open(res["path"]) as f:
        got = json.load(f)
    assert list(want["per_seq"]) == list(got["per_seq"]) == keys
    assert set(want["summary"]) == set(got["summary"]) == {*METRICS,
                                                           "coverage"}
    assert want["summary"]["coverage"] == got["summary"]["coverage"]
    for key, mj in want["per_seq"].items():
        for k in METRICS:
            mt = got["per_seq"][key][k]
            assert abs(mj[k] - mt) <= 1.0 + 0.02 * abs(mj[k]), (key, k)
    dj = joblib_compat.load(str(tmp_path / "jax.pkl"))
    with open(tmp_path / "port.pkl", "rb") as f:
        dt = pickle.load(f)
    for key in keys:
        np.testing.assert_array_equal(np.asarray(dj[key]["gt"]),
                                      dt[key]["gt"])
        err = np.abs(np.asarray(dj[key]["pred"]) - dt[key]["pred"]).max()
        print(f"eval_relive {key}: pred qpos port vs JAX {err:.3e}")
        close(dj[key]["pred"], dt[key]["pred"], QPOS_TOL)
        close(dj[key]["percent"], dt[key]["percent"], 1e-6)
