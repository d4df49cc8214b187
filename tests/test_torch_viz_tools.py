"""Inspection tools of the port against the JAX package's: the headless
visualizer (uhc_tpu_torch.utils.visualizer: frames drawn from the same
joint positions are the same pixels; `fk_jpos`, render_eval_result's FK,
against the JAX FK within 2e-6 m), media (chunking, crops, resize, cv2
video IO), the interactive viewer (the same PlaybackState after every key
and tick of a seeded sequence; the matplotlib shell under Agg), vis_model
(the same MJCF text from the stand-in's file; the JAX test reads the
reference MJCF, which is not in the repository), cli/replay on both
packages' dumps, cli/smpl_rig_convert (qpos within 1e-5 of the JAX
package's smpl_to_qpose) and cli/render_smpl_rig on the stand-in. A
missing matplotlib or cv2 raises ImportError; the CLIs default to CUDA."""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from test_torch_helpers import GAIT, close, few_threads, load_both

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


def _jpos(T=5, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.normal(scale=0.2, size=(T, 24, 3)) + [0, 0, 1.0]
    return pred, pred + 0.05


def _pixels(path):
    import matplotlib.image as mpimg

    return mpimg.imread(path)


def test_render_comparison_same_pixels(tmp_path):
    from uhc_tpu.utils import visualizer as JV
    from uhc_tpu_torch.utils import visualizer as V

    pred, gt = _jpos()
    vf = np.random.default_rng(1).normal(size=(5, 24, 6)) * 50
    for pkg, mod in (("jax", JV), ("torch", V)):
        out = mod.render_comparison(pred, gt, str(tmp_path / f"{pkg}.png"),
                                    stride=2, vf_seq=vf)
        assert out == str(tmp_path / f"{pkg}_*.png")
    for t in (0, 2, 4):
        a = _pixels(tmp_path / f"jax_{t:04d}.png")
        b = _pixels(tmp_path / f"torch_{t:04d}.png")
        np.testing.assert_array_equal(a, b)
    gif = V.render_comparison(pred, gt, str(tmp_path / "clip.gif"),
                              stride=2, vf_seq=np.ones((5, 6)))
    assert gif.endswith(".gif") and os.path.getsize(gif) > 0
    # mp4: ffmpeg if the host has it, else the gif fallback
    mp4 = V.render_comparison(pred, None, str(tmp_path / "clip.mp4"))
    assert os.path.getsize(mp4) > 0


def test_display_coverage_same_pixels(tmp_path):
    from uhc_tpu.utils import visualizer as JV
    from uhc_tpu_torch.utils import visualizer as V

    res = {f"seq{i}_{'x' * (4 * i)}": {"succ": i % 2, "mpjpe": 30.0 + i}
           for i in range(7)}
    a = JV.display_coverage(res, str(tmp_path / "a.png"))
    b = V.display_coverage(res, str(tmp_path / "b.png"))
    np.testing.assert_array_equal(_pixels(a), _pixels(b))


def test_fk_and_render_eval_result(tmp_path):
    import jax
    import jax.numpy as jnp

    from uhc_tpu.physics import engine as JE
    from uhc_tpu_torch.data.dataset import load_motion_file
    from uhc_tpu_torch.smpl.convert import smpl_to_qpose
    from uhc_tpu_torch.utils import visualizer as V

    (jt, jm), (tt, tm) = load_both(tmp_path)
    clip = load_motion_file(GAIT)["0-SYN_walk_turn"]
    q = smpl_to_qpose(clip["pose_aa"][:12], tm.body_pos[0],
                      clip["trans"][:12]).numpy()
    want = np.asarray(jax.vmap(lambda x: JE.fk(jt, jm, x)["xpos"])(
        jnp.asarray(q)))
    got = V.fk_jpos(tt, tm, q, "cpu")
    close(want, got, 2e-6)
    # a model already on the device, and a tensor trajectory
    from uhc_tpu_torch.physics.model import model_from_numpy

    close(want, V.fk_jpos(tt, model_from_numpy(tm, "cpu"),
                          torch.from_numpy(q), "cpu"), 2e-6)
    out = V.render_eval_result(tt, tm, q[:3], q[:3],
                               out_path=str(tmp_path / "e.png"),
                               device="cpu")
    assert sorted(os.listdir(tmp_path)).count("e_0002.png") == 1
    assert out.endswith("_*.png")


def test_missing_matplotlib_or_cv2_raises(tmp_path, monkeypatch):
    from uhc_tpu_torch.utils import media, visualizer as V

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pred, gt = _jpos()
    with pytest.raises(ImportError, match="matplotlib is required"):
        V.render_comparison(pred, gt, str(tmp_path / "x.gif"))
    with pytest.raises(ImportError, match="matplotlib is required"):
        V.display_coverage({"a": {"succ": 1}}, str(tmp_path / "c.png"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV is required"):
        media.read_video_frames(str(tmp_path / "none.mp4"))
    with pytest.raises(ImportError, match="OpenCV is required"):
        media.write_frames_to_video([np.zeros((8, 8, 3), np.uint8)],
                                    str(tmp_path / "v.mp4"))


@pytest.mark.parametrize("n,w,ov", [(50, 80, 10), (81, 80, 10),
                                    (247, 80, 10), (95, 32, 8),
                                    (320, 64, 16)])
def test_media_chunks(n, w, ov):
    from uhc_tpu.utils import media as JM
    from uhc_tpu_torch.utils import media as M

    for idx in (False, True):
        (jc, js), (tc, ts) = (JM.get_chunk_with_overlap(n, w, ov, idx),
                              M.get_chunk_with_overlap(n, w, ov, idx))
        assert js == ts and len(jc) == len(tc)
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(a, b)
    chunks, selects = M.get_chunk_with_overlap(n, w, ov)
    stitched = np.concatenate([c[a if a >= 0 else len(c) + a:b]
                               for c, (a, b) in zip(chunks, selects)])
    np.testing.assert_array_equal(stitched, np.arange(n))


def test_media_crops_resize_and_video(tmp_path, monkeypatch):
    from uhc_tpu.utils import media as JM
    from uhc_tpu_torch.utils import media as M

    img = np.random.default_rng(2).integers(0, 255, (40, 60, 3), np.uint8)
    for f in ("crop_center", "crop_side"):
        np.testing.assert_array_equal(getattr(JM, f)(img, 20, 10),
                                      getattr(M, f)(img, 20, 10))
    for a, b in zip(JM.resize_frames([img, img[::2]], 16, 8),
                    M.resize_frames([img, img[::2]], 16, 8)):
        np.testing.assert_array_equal(a, b)
    frames = [np.full((32, 48, 3), 8 * i, np.uint8) for i in range(6)]
    for pkg, mod in (("jax", JM), ("torch", M)):
        mod.write_frames_to_video(frames, str(tmp_path / f"{pkg}.mp4"),
                                  add_text="t")
        mod.write_individual_frames(frames, str(tmp_path / pkg))
        mod.assemble_videos([frames, frames[::-1]], (1, 2), ["a", "b"],
                            str(tmp_path / f"{pkg}_grid.mp4"))
    for a, b in ((M.read_video_frames(str(tmp_path / "jax.mp4")),
                  M.read_video_frames(str(tmp_path / "torch.mp4"))),
                 (JM.read_img_dir(str(tmp_path / "jax")),
                  M.read_img_dir(str(tmp_path / "torch"))),
                 (M.read_video_frames(str(tmp_path / "jax_grid.mp4")),
                  M.read_video_frames(str(tmp_path / "torch_grid.mp4")))):
        assert len(a) == len(b) == 6
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # without cv2: the nearest-neighbor resize of both packages
    monkeypatch.setitem(sys.modules, "cv2", None)
    for a, b in zip(JM.resize_frames([img], 17, 9),
                    M.resize_frames([img], 17, 9)):
        assert b.shape == (9, 17, 3)
        np.testing.assert_array_equal(a, b)


def test_playback_state_key_sequence():
    import dataclasses

    from uhc_tpu.utils.interactive import T_ARR as JT_ARR
    from uhc_tpu.utils.interactive import PlaybackState as J
    from uhc_tpu_torch.utils.interactive import T_ARR, PlaybackState as P

    assert T_ARR == JT_ARR
    keys = [" ", "space", "s", "right", "left", "q", "w", "e", "g", "d",
            "f", "t", "v", "z", None, "Right", "LEFT", "tick", "tick",
            "tick"]
    rng = np.random.default_rng(5)
    for num_fr, takes, T in ((10, 3, 12), (4, 1, 2), (1, 2, 1)):
        j, p = J(num_fr, takes, T=T), P(num_fr, takes, T=T)
        for k in rng.choice(len(keys), 400):
            key = keys[k]
            if key == "tick":
                assert j.tick() == p.tick()
            else:
                assert j.on_key(key) == p.on_key(key)
            assert dataclasses.asdict(j) == dataclasses.asdict(p)


def test_viewer_agg(tmp_path):
    import matplotlib

    matplotlib.use("Agg", force=True)
    from uhc_tpu_torch.utils.interactive import InteractiveViewer

    rng = np.random.default_rng(0)
    takes = {f"take{i}": {"pred_jpos": rng.normal(size=(6 + i, 24, 3)),
                          "gt_jpos": rng.normal(size=(6 + i, 72))}
             for i in range(2)}
    v = InteractiveViewer(takes, out_dir=str(tmp_path), backend="Agg")

    class Ev:
        def __init__(self, key):
            self.key = key

    v._on_key(Ev("right"))
    assert v.state.fr == 1
    v._on_key(Ev("q"))
    assert v.state.take == 1 and v.state.num_fr == 7
    v._on_key(Ev("t"))
    assert len(list(tmp_path.glob("frame_take1_*.png"))) == 1
    v._on_key(Ev("v"))
    assert list(tmp_path.glob("take_take1.*"))
    v.state.T = 1
    for _ in range(3):
        v.step()
    assert v.state.fr == 3 and "take1" in v.ax.get_title()


def test_vis_model_on_stand_in(tmp_path):
    import xml.etree.ElementTree as ET

    from uhc_tpu.utils.vis_model import create_vis_model as jvis
    from uhc_tpu_torch.smpl.fixture_humanoid import write_fixture_humanoid
    from uhc_tpu_torch.utils import vis_model

    src = write_fixture_humanoid(str(tmp_path))
    jvis(src, str(tmp_path / "j.xml"), num=3)
    vis_model.main(["--in-model", src, "--out-model",
                    str(tmp_path / "t.xml"), "--num", "3"])
    assert (tmp_path / "j.xml").read_text() == (tmp_path / "t.xml").read_text()
    root = ET.parse(tmp_path / "t.xml").getroot()
    assert root.find("actuator") is None
    assert any(f.get("contact") == "disable"
               for f in root.find("option").findall("flag"))
    names = [b.get("name") for b in root.find("worldbody").findall("body")]
    assert len(names) == 3 and names[1].startswith("1_")
    joints = [j.get("name") for j in root.iter("joint")]
    assert len(joints) == len(set(joints))


def _dumps(tmp_path):
    """A dump as cli/eval writes it (plain pickle) and as the JAX CLI
    writes it (joblib)."""
    import joblib

    rng = np.random.RandomState(7)
    takes = {k: {"pred_jpos": rng.randn(4, 24, 3).astype(np.float32),
                 "gt_jpos": rng.randn(4, 24, 3).astype(np.float32),
                 "pred_qpos": rng.randn(4, 76).astype(np.float32),
                 "gt_qpos": rng.randn(4, 76).astype(np.float32),
                 "percent": 0.5 + i / 4, "fail_safe": bool(i)}
             for i, k in enumerate(("takeA", "takeB"))}
    plain, jl = str(tmp_path / "plain.pkl"), str(tmp_path / "jl.pkl")
    with open(plain, "wb") as f:
        pickle.dump(takes, f)
    joblib.dump(takes, jl)
    return takes, plain, jl


def test_replay_cli(tmp_path, capsys):
    from uhc_tpu.cli import replay as jreplay
    from uhc_tpu_torch.cli import replay

    takes, plain, jl = _dumps(tmp_path)
    for path in (plain, jl):
        capsys.readouterr()
        jreplay.main(["--data", path, "--list"])
        want = capsys.readouterr().out
        replay.main(["--data", path, "--list"])
        assert capsys.readouterr().out == want and "takeB: 4 frames" in want
        for pkg, mod in (("jax", jreplay), ("torch", replay)):
            mod.main(["--data", path, "--take", "takeB", "--dump-states",
                      str(tmp_path / f"{pkg}.npz"),
                      "--out", str(tmp_path / f"{pkg}.png")])
        a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "torch.npz")
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
        np.testing.assert_array_equal(b["pred_jpos"],
                                      takes["takeB"]["pred_jpos"])
        np.testing.assert_array_equal(_pixels(tmp_path / "jax_0003.png"),
                                      _pixels(tmp_path / "torch_0003.png"))
    # the arrays only, nothing rendered
    replay.main(["--data", plain, "--take", "takeA", "--dump-states",
                 str(tmp_path / "only.npz"), "--no-render",
                 "--out", str(tmp_path / "none.png")])
    assert not list(tmp_path.glob("none_*.png"))
    replay.main(["--data", plain, "--all", "--out", "x.png", "--out-dir",
                 str(tmp_path / "all")])
    assert len(list((tmp_path / "all").glob("takeA_*.png"))) == 4
    with pytest.raises(SystemExit):
        replay.main(["--data", plain, "--take", "nope"])


def test_smpl_rig_convert(tmp_path):
    from uhc_tpu.smpl.convert import smpl_to_qpose as jconv
    from uhc_tpu.smpl.convert import smpl_to_qpose_ball as jconv_ball
    from uhc_tpu_torch.cli import smpl_rig_convert
    from uhc_tpu_torch.data import joblib_compat
    from uhc_tpu_torch.data.dataset import load_motion_file
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    _, model = load_fixture_humanoid()
    clips = load_motion_file(GAIT)
    rng = np.random.default_rng(9)
    # a 156-wide SMPL-H pose keeps its 22 body joints
    src = str(tmp_path / "mini.pkl")
    mini = {k: {"pose_aa": np.concatenate(
        [v["pose_aa"][:9], rng.normal(size=(9, 84))], 1).astype(np.float32),
        "trans": v["trans"][:9]} for k, v in list(clips.items())[:2]}
    with open(src, "wb") as f:
        pickle.dump(mini, f)
    for ball, conv, ext in ((False, jconv, "npz"), (True, jconv_ball, "p")):
        out = str(tmp_path / f"rig_{ball}.{ext}")
        smpl_rig_convert.main(["--data", src, "--out", out, "--device",
                               "cpu", "--offset-z", "0.1"]
                              + (["--ball"] if ball else []))
        got = (dict(np.load(out)) if ext == "npz"
               else joblib_compat.load(out))
        for k, v in mini.items():
            pose = np.concatenate([v["pose_aa"][:, :66],
                                   np.zeros((9, 6), np.float32)], 1)
            want = np.array(conv(pose, model.body_pos[0], v["trans"]))
            want[:, 2] += 0.1
            assert got[k].shape == (9, 99 if ball else 76)
            close(want, got[k], 1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            smpl_rig_convert.main(["--data", src, "--out", out])


def test_render_smpl_rig(tmp_path):
    from uhc_tpu_torch.cli import render_smpl_rig

    src = str(tmp_path / "mini.pkl")
    with open(src, "wb") as f:
        pickle.dump({"clip a": {"pose_aa": np.zeros((8, 156), np.float32),
                                "trans": np.zeros((8, 3), np.float32)},
                     "clip b": {"pose_aa": np.zeros((8, 72), np.float32)}},
                    f)
    out_dir = str(tmp_path / "renders")
    paths = render_smpl_rig.main(["--data", src, "--output-dir", out_dir,
                                  "--fmt", "png", "--max-frames", "3",
                                  "--stride", "2", "--device", "cpu"])
    assert sorted(paths) == ["clip a", "clip b"]
    assert sorted(os.listdir(out_dir)) == [
        "clip_a_0000.png", "clip_a_0002.png", "clip_b_0000.png",
        "clip_b_0002.png"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            render_smpl_rig.main(["--data", src, "--output-dir", out_dir])
