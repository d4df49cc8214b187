"""Offline AMASS ETL (uhc_tpu_torch.data.process_amass) against the JAX
package's: the directory reader, resampling, the occlusion filter and the
splits on a synthetic raw DB with and without grounding (the same seeded
SMPL stand-in on both sides), axis-angle -> 6d, and chip_smoke's phase
`tools` input (the gait clips as an AMASS directory) through the port's
CLI, loaded back by the port's `load_motion_file` into an expert library.
Tolerances: pose, betas, x / y of trans exact; the 6d rotations and the
grounded z within 2e-6 (float32 LBS and rotations in another order)."""
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_helpers import GAIT, close, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


def _raw_seq(T=40, fr=120, gender=b"male", seed=0):
    rng = np.random.default_rng(seed)
    return {
        "poses": rng.normal(scale=0.2, size=(T, 156)).astype(np.float64),
        "trans": rng.normal(scale=0.1, size=(T, 3)).astype(np.float64)
        + [0.0, 0.0, 0.9],
        "betas": rng.normal(scale=0.5, size=16).astype(np.float64),
        "mocap_framerate": np.asarray(fr),
        "gender": gender,
    }


RAW = {
    "CMU_s1_walk": _raw_seq(T=120, fr=120),
    "CMU_s1_short": _raw_seq(T=20, fr=120, seed=1),     # 5 frames: dropped
    "Transitions_mocap_s2_run": _raw_seq(T=60, fr=60, seed=2),
    "HumanEva_s5_jog": _raw_seq(T=90, fr=30, gender=np.asarray("female"),
                                seed=3),
    "CMU_s3_sit": _raw_seq(T=120, fr=120, seed=4),      # clipped at 15
    "CMU_s4_fly": _raw_seq(T=120, fr=120, seed=5),      # irrecoverable
    "CMU_s6_air": _raw_seq(T=120, fr=120, seed=6),      # bound 8: dropped
    "Unknown_s7_x": _raw_seq(T=50, fr=50, seed=7),      # no corpus: train
}
OCCLUSION = {
    "0-CMU_s3_sit": {"issue": "sitting", "idxes": [15]},
    "0-CMU_s4_fly": {"issue": "unknown"},
    "0-CMU_s6_air": {"issue": "airborne", "idxes": [8]},
}


def _same_db(want, got, z_atol):
    assert list(want) == list(got)
    for k in want:
        w, g = want[k], got[k]
        assert set(w) == set(g)
        assert w["seq_name"] == g["seq_name"] and w["gender"] == g["gender"]
        close(w["pose_aa"], g["pose_aa"], 0.0)
        close(w["beta"], g["beta"], 0.0)
        close(w["trans"][:, :2], g["trans"][:, :2], 0.0)
        close(w["trans"][:, 2], g["trans"][:, 2], z_atol)
        close(w["pose_6d"], g["pose_6d"], 2e-6)
        for f in ("pose_aa", "pose_6d", "trans", "beta"):
            assert g[f].dtype == np.float32


@pytest.mark.parametrize("grounded", [False, True])
def test_process_db_against_jax(grounded):
    from uhc_tpu.data import process_amass as JPA
    from uhc_tpu.smpl.lbs import synthetic_smpl_data as jdata
    from uhc_tpu_torch.data import process_amass as PA
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data

    want = JPA.process_amass_db(RAW, OCCLUSION,
                                jdata() if grounded else None)
    got = PA.process_amass_db(RAW, OCCLUSION,
                              synthetic_smpl_data() if grounded else None,
                              device="cpu")
    assert set(got) == {"0-CMU_s1_walk", "0-Transitions_mocap_s2_run",
                        "0-HumanEva_s5_jog", "0-CMU_s3_sit", "0-Unknown_s7_x"}
    _same_db(want, got, 2e-6 if grounded else 0.0)
    assert got["0-CMU_s3_sit"]["pose_aa"].shape == (15, 156)
    assert got["0-CMU_s1_walk"]["pose_6d"].shape == (30, 52, 6)
    assert got["0-HumanEva_s5_jog"]["gender"] == "female"
    if not grounded:
        close(RAW["CMU_s1_walk"]["trans"][::4].astype(np.float32),
              got["0-CMU_s1_walk"]["trans"], 0.0)
    js, ts = JPA.split_amass_db(want), PA.split_amass_db(got)
    assert {s: sorted(d) for s, d in js.items()} == {
        s: sorted(d) for s, d in ts.items()}
    assert sorted(ts["test"]) == ["0-Transitions_mocap_s2_run"]
    assert sorted(ts["vald"]) == ["0-HumanEva_s5_jog"]
    assert PA.count_consec([3, 4, 5, 9, 10, 12]) == JPA.count_consec(
        [3, 4, 5, 9, 10, 12]) == [3, 2, 1]


def test_orth6d_and_fix_height():
    import jax.numpy as jnp

    from uhc_tpu.data import process_amass as JPA
    from uhc_tpu.smpl.lbs import lbs as jlbs
    from uhc_tpu.smpl.lbs import synthetic_smpl_data as jdata
    from uhc_tpu_torch.data import process_amass as PA
    from uhc_tpu_torch.smpl.lbs import synthetic_smpl_data

    rng = np.random.default_rng(8)
    aa = rng.normal(scale=1.2, size=(9, 72))
    six = PA.aa_to_orth6d(aa, device="cpu")
    close(JPA.aa_to_orth6d(aa), six, 2e-6)
    # the identity's first two columns, and each pair orthonormal
    close([[1, 0, 0, 0, 1, 0]], PA.aa_to_orth6d(np.zeros((1, 3)),
                                                device="cpu")[0], 0.0)
    c0, c1 = six[..., :3], six[..., 3:]
    close(np.ones(c0.shape[:-1]), np.linalg.norm(c0, axis=-1), 1e-6)
    close(np.zeros(c0.shape[:-1]), (c0 * c1).sum(-1), 1e-6)

    raw = _raw_seq(T=12, fr=30, seed=9)
    trans = PA.fix_height_smpl_vanilla(synthetic_smpl_data(), raw["poses"],
                                       raw["trans"], raw["betas"],
                                       device="cpu")
    jtrans = JPA.fix_height_smpl_vanilla(jdata(), raw["poses"],
                                         raw["trans"], raw["betas"])
    close(jtrans, trans, 2e-6)
    b = np.zeros(16, np.float32)
    b[:] = raw["betas"][:16]
    verts, _ = jlbs(jdata(), jnp.asarray(
        raw["poses"][0][:72].reshape(24, 3).astype(np.float32)),
        jnp.asarray(b), jnp.asarray(trans[0].astype(np.float32)))
    assert abs(float(jnp.min(verts[:, 2]))) < 1e-5


def test_gait_clips_as_amass_through_the_cli(tmp_path):
    """chip_smoke's tools input: the six gait clips in three corpora (one
    per split), repeated ×4 at 120 Hz and padded to 156 dofs, through the
    port's CLI with grounding on the CPU and through the JAX package's
    functions; each split holds its corpus' clips, every 30 Hz pose is the
    clip's, and a split loads into the port's expert library."""
    import chip_smoke as C
    from uhc_tpu.data import process_amass as JPA
    from uhc_tpu.smpl.lbs import load_smpl_data as jload
    from uhc_tpu_torch.data import process_amass as PA
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid
    from uhc_tpu_torch.smpl.lbs import load_smpl_data

    clips = load_motion_file(GAIT)
    raw, keys = C.amass_raw(clips)
    d = str(tmp_path)
    C.write_amass_dir(os.path.join(d, "amass"), raw)
    smpl = C.stand_in_smpl_file(d)
    paths = PA.main(["--dir", os.path.join(d, "amass"), "--out_dir",
                     os.path.join(d, "out"), "--smpl", smpl,
                     "--device", "cpu"])
    cpu_db = PA.process_amass_db(PA.read_amass_dir(os.path.join(d, "amass")),
                                 None, load_smpl_data(smpl), device="cpu")
    assert C.amass_check(paths, keys, clips,
                         {k: v["trans"] for k, v in cpu_db.items()}) == []
    jraw = JPA.read_amass_dir(os.path.join(d, "amass"))
    assert list(jraw) == list(PA.read_amass_dir(os.path.join(d, "amass")))
    want = JPA.process_amass_db(jraw, None, jload(smpl))
    _same_db(want, cpu_db, 2e-6)
    # grounded at the soles: the stand-in's skeleton, not sunk
    for k, v in cpu_db.items():
        assert 0.85 < v["trans"][0, 2] < 1.0, (k, v["trans"][0])
    with open(paths["train"], "rb") as f:
        assert set(pickle.load(f)) == {k for k in keys if "CMU" in k}
    topo, model = load_fixture_humanoid()
    lib, lkeys = build_expert_library(topo, model_from_numpy(model, "cpu"),
                                      load_motion_file(paths["test"]),
                                      max_len=20)
    assert len(lkeys) == 2 and lib["qpos"].shape == (2, 20, 76)
    # no --device: CUDA, which this host lacks, so it raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PA.main(["--dir", os.path.join(d, "amass"), "--out_dir",
                     os.path.join(d, "out2")])
