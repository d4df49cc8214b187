"""Host data tools of the port against the JAX package's: the BVH / AMC
parsers and `interpolated_traj` (uhc_tpu_torch.data.mocap), the H36M
pipeline (data.h36m: euler conventions, qpos layout, conversion, the MJCF
string), the keypoint registry (data.keypoints, numpy and torch paths)
and the convert_h36m CLI. Host numpy on both sides: equal to the bit
(tolerance 0) unless a line says otherwise. The rzxy convention is held
against scipy's intrinsic "ZXY" rotation (1e-12), where the JAX package's
own test reads the reference code, which is not in the repository."""
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

from test_torch_helpers import close, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

BVH = """HIERARCHY
ROOT Hips
{
  OFFSET 0.0 0.0 0.0
  CHANNELS 6 Xposition Yposition Zposition Zrotation Yrotation Xrotation
  JOINT Chest
  {
    OFFSET 0.0 10.0 0.0
    CHANNELS 3 Zrotation Yrotation Xrotation
    JOINT Neck
    {
      OFFSET 0.0 8.0 1.0
      CHANNELS 3 Zrotation Xrotation Yrotation
      End Site
      {
        OFFSET 0.0 5.0 0.0
      }
    }
  }
}
MOTION
Frames: {n}
Frame Time: 0.008333
{frames}
"""

AMC = """#!OML:ASF
:FULLY-SPECIFIED
:DEGREES
1
root 0 0 17 0 90 0
lowerback 1 2 3
lfoot 5
rfoot 4 7
2
root 0 0 17.5 0 90 0
lowerback 2 3 4
lfoot 6
rfoot 5 8
3
root 0.5 0 18 1 91 2
lowerback 3 4 5
lfoot 7
rfoot 6 9
"""


def _bvh_text(n=40, seed=0):
    rng = np.random.RandomState(seed)
    frames = rng.uniform(-170, 170, (n, 12))
    frames[:, :3] = rng.uniform(-50, 50, (n, 3))
    return BVH.replace("{n}", str(n)).replace(
        "{frames}", "\n".join(" ".join(f"{x:.4f}" for x in f)
                              for f in frames))


def test_bvh_amc_and_resampling(tmp_path):
    from uhc_tpu.data import mocap as JM
    from uhc_tpu_torch.data import mocap as M

    p = tmp_path / "clip.bvh"
    p.write_text(_bvh_text())
    jp, ja, jf = JM.load_bvh_file(str(p), len_scale=0.01)
    tp, ta, tf = M.load_bvh_file(str(p), len_scale=0.01)
    close(jp, tp, 0.0)
    assert ja == ta == {"Hips": (0, 6), "Chest": (6, 9), "Neck": (9, 12)}
    assert jf == tf
    # 40 frames at 120 Hz resampled to 30 Hz, and to an odd period
    for dt in (1 / 30, 0.0137):
        close(JM.interpolated_traj(jp, dt, 120),
              M.interpolated_traj(tp, dt, 120), 0.0)

    a = tmp_path / "clip.amc"
    a.write_text(AMC)
    (jp, ja), (tp, ta) = (JM.load_amc_file(str(a), 0.056444),
                          M.load_amc_file(str(a), 0.056444))
    close(jp, tp, 0.0)
    assert ja == ta and ta["lfoot"][1] - ta["lfoot"][0] == 2


def test_h36m_euler_conventions():
    from scipy.spatial.transform import Rotation

    from uhc_tpu.data import h36m as JH
    from uhc_tpu_torch.data import h36m as H

    rng = np.random.RandomState(0)
    for axes in sorted(H._AXES2TUPLE):
        for _ in range(5):
            a, b, c = rng.uniform(-np.pi, np.pi, 3)
            close(JH._quat_from_euler(a, b, c, axes),
                  H._quat_from_euler(a, b, c, axes), 0.0)
    for _ in range(50):
        a, b, c = rng.uniform(-np.pi, np.pi, 3)
        q = H._quat_from_euler(a, b, c, "rzxy")
        r = Rotation.from_euler("ZXY", [a, b, c]).as_quat(scalar_first=True)
        assert abs(abs(np.dot(q, r)) - 1.0) < 1e-12


def _synthetic_raw(T=100, seed=1):
    """D3_Angles-format poses: (T, 78), trans in mm, degrees at 50 Hz,
    with angles past ±180° so the wrap is exercised."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, T)[:, None]
    poses = rng.uniform(5, 250, (1, 78)) * np.sin(
        t + rng.uniform(0, 2 * np.pi, (1, 78)))
    poses[:, 0:3] = 1000.0 * np.stack(
        [0.3 * np.sin(t[:, 0]), 0.2 * np.cos(t[:, 0]),
         0.95 + 0.02 * np.sin(2 * t[:, 0])], 1)
    return poses


def test_h36m_layout_conversion_and_mjcf():
    from uhc_tpu.data import h36m as JH
    from uhc_tpu_torch.data import h36m as H

    assert H.model_bones() == JH.model_bones()
    assert H.body_qposaddr() == JH.body_qposaddr()
    assert H.h36m_nq() == JH.h36m_nq() == 53
    for k, v in JH.h36m_offsets().items():
        close(v, H.h36m_offsets()[k], 0.0)
    data = {"S1": {"Walking": _synthetic_raw()},
            "S9": {"Sitting": _synthetic_raw(80, seed=2)},
            "S5": {"Eating": _synthetic_raw(64, seed=3)}}
    for fr, dt in ((50, 1 / 30), (60, 1 / 25)):
        want = JH.convert_h36m_dict(data, mocap_fr=fr, dt=dt)
        got = H.convert_h36m_dict(data, mocap_fr=fr, dt=dt)
        for s in data:
            for a in data[s]:
                close(want[s][a], got[s][a], 0.0)
    assert H.h36m_mjcf_string() == JH.h36m_mjcf_string()
    kw = dict(offset=np.array([0.1, -0.2, 0.9]), bone_scale=0.012,
              geom_radius=0.03, timestep=1 / 300)
    assert H.h36m_mjcf_string(**kw) == JH.h36m_mjcf_string(**kw)
    with pytest.raises(ImportError):
        H.load_h36m_raw("/nonexistent")


def test_keypoints():
    import jax.numpy as jnp

    from uhc_tpu.data import keypoints as JK
    from uhc_tpu_torch.data import keypoints as K

    rng = np.random.RandomState(4)
    assert K.FORMATS == JK.FORMATS
    for name, edges in JK.SKELETONS.items():
        close(edges, K.skeleton(name), 0.0)
    for src in K.FORMATS:
        for dst in K.FORMATS:
            P, present = K.conversion(src, dst)
            JP, Jpresent = JK.conversion(src, dst)
            close(JP, P, 0.0)
            close(Jpresent, present, 0.0)
            assert K.perm_idxs(src, dst) == JK.perm_idxs(src, dst)
            kp = rng.randn(3, len(K.joint_names(src)), 3).astype(np.float32)
            want = JK.convert_kps(kp, src, dst)
            close(want, K.convert_kps(kp, src, dst), 0.0)
            # the torch path against the JAX path (a one-hot matmul:
            # equal to the bit)
            close(np.asarray(JK.convert_kps(jnp.asarray(kp), src, dst)),
                  K.convert_kps(torch.from_numpy(kp), src, dst), 0.0)
    kp = rng.rand(7, 17, 3) * 100
    close(JK.keypoint_hflip(kp, 224), K.keypoint_hflip(kp, 224), 0.0)
    flipped = K.keypoint_hflip(kp, 224)
    assert flipped is not kp
    close(kp, K.keypoint_hflip(flipped, 224), 1e-12)
    with pytest.raises(KeyError):
        K.joint_names("openpose-135")


def test_convert_h36m_cli(tmp_path):
    from uhc_tpu_torch.cli import convert_h36m

    src = str(tmp_path / "h36m_raw.p")
    with open(src, "wb") as f:
        pickle.dump({"S1": {"Walk": _synthetic_raw(50, 5)},
                     "S6": {"Greet": _synthetic_raw(70, 6)}}, f)
    outs = {}
    for pkg in ("jax", "torch"):
        out = str(tmp_path / f"{pkg}_qpos.p")
        xml = str(tmp_path / f"{pkg}.xml")
        argv = ["--data", src, "--out", out, "--write-model", xml,
                "--mocap-fr", "50"]
        if pkg == "torch":
            convert_h36m.main(argv)
        else:
            old = sys.argv
            sys.argv = ["convert_h36m"] + argv
            try:
                runpy.run_module("uhc_tpu.cli.convert_h36m",
                                 run_name="__main__")
            finally:
                sys.argv = old
        with open(out, "rb") as f:
            outs[pkg] = (pickle.load(f), open(xml).read())
    (jq, jx), (tq, tx) = outs["jax"], outs["torch"]
    assert jx == tx and "<mujoco" in tx
    for s in jq:
        for a in jq[s]:
            assert tq[s][a].shape[1] == 53
            close(jq[s][a], tq[s][a], 0.0)
