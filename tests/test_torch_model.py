"""PyTorch port: stand-in humanoid, MJCF loader, joblib-free reader,
import hygiene."""
import dataclasses
import glob
import os
import subprocess
import sys

import joblib
import numpy as np
import pytest

from test_torch_helpers import load_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return load_both(tmp_path_factory.mktemp("standin"))


def test_mjcf_load_matches_jax(both):
    """Every Model field equals the JAX loader's on the same files, ≤ 1e-6
    (both run the same float64 mesh algebra and round to float32)."""
    (jt, jm), (tt, tm) = both
    assert (tt.nbody, tt.parents, tt.body_names) == (jt.nbody, jt.parents,
                                                     jt.body_names)
    assert (tt.nq, tt.nv, tt.ndof) == (76, 75, 69)
    for f in dataclasses.fields(jm):
        a = np.asarray(getattr(jm, f.name))
        b = np.asarray(getattr(tm, f.name))
        assert a.shape == b.shape, f.name
        assert np.max(np.abs(a - b), initial=0.0) <= 1e-6, f.name


def test_standin_is_an_adult_humanoid(both):
    _, (topo, m) = both
    assert 45.0 < float(m.body_mass.sum()) < 90.0
    assert np.all(m.body_mass > 0.05) and np.all(m.body_inertia > 0)
    # feet carry 16 hull points, other bodies 8
    assert m.contact_mask.sum(1).tolist() == [
        16 if n in ("L_Ankle", "R_Ankle", "L_Toe", "R_Toe") else 8
        for n in topo.body_names]
    # soles about 0.92 m below the pelvis origin (SMPL frame: +y up)
    sole = m.contact_point[3][:, 1].min() + sum(
        m.body_pos[i][1] for i in (1, 2, 3))
    assert -0.98 < sole < -0.88
    # depth-first order: subtrees are contiguous
    assert topo.subtree_end().tolist()[:5] == [24, 5, 5, 5, 5]


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "sample_data", "*.pkl"))),
    ids=lambda p: os.path.basename(p))
def test_joblib_free_reader_matches_joblib(path):
    from uhc_tpu_torch.data import joblib_compat

    want, got = joblib.load(path), joblib_compat.load(path)

    def same(a, b, where):
        if isinstance(a, dict):
            assert list(a) == list(b), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, where
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            assert a == b, where

    same(want, got, os.path.basename(path))


def test_reader_loads_checkpoint_pickle():
    import pickle

    from uhc_tpu_torch.data import joblib_compat

    path = os.path.join(REPO, "results", "uhc_implicit", "models",
                        "iter_best.p")
    with open(path, "rb") as f:
        want = pickle.load(f)
    got = joblib_compat.load(path)
    for k in ("mean", "m2", "n"):
        np.testing.assert_array_equal(want["running_stats"][k],
                                      got["running_stats"][k])


def test_port_imports_no_jax_joblib_yaml():
    """Import every module of uhc_tpu_torch (and chip_smoke) with jax,
    uhc_tpu, joblib and yaml blocked in sys.modules."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "uhc_tpu", "joblib", "yaml", "triton"):
    sys.modules[name] = None
import uhc_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(uhc_tpu_torch.__path__,
                                              "uhc_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [n for n in sys.modules if n.split(".")[0] in
       ("jax", "jaxlib", "uhc_tpu", "joblib", "yaml", "triton")
       and sys.modules[n] is not None]
assert not bad, bad
print(" ".join(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 45
    # the training slice and K2, the shape slice and K1e
    assert {f"uhc_tpu_torch.{m}" for m in (
        "cli.train", "learn.agent", "learn.rollout", "learn.gae",
        "learn.ppo", "data.sampling", "utils.metrics_sink",
        "physics.control_step_split", "smpl.lbs", "smpl.robot",
        "data.dataset", "physics.model", "learn.metrics",
        "smpl.convert")} <= mods


def test_chip_smoke_fails_without_card(tmp_path):
    """No CUDA here: the script must exit non-zero and print no result,
    also when copied alone into an empty directory."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd, script in ((REPO, "chip_smoke.py"),
                        (str(tmp_path), shutil.copy(
                            os.path.join(REPO, "chip_smoke.py"), tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
