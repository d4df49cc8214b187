"""Motion pkl -> MuJoCo qpos conversion (PyTorch twin of
uhc_tpu.cli.smpl_rig_convert), on the stand-in humanoid
(`smpl/fixture_humanoid.py`) as cli/eval builds it; the JAX script reads
the reference MJCF, which is not in the repository.

Converts every clip's SMPL pose to qpos (`smpl_to_qpose`, or the
ball-joint layout with --ball) on the device, writes the qpos tracks (npz,
or a plain pickle for any other extension), and optionally renders the
first clip (matplotlib).

Usage:
  python -m uhc_tpu_torch.cli.smpl_rig_convert --data <motion pkl> \\
      --out out.npz [--offset-z 0.0] [--render out.gif] [--ball] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np


def convert(seqs: dict, root_offset, ball: bool, offset_z: float,
            device) -> dict:
    """{key: {pose_aa, trans}} -> {key: (T, nq) qpos} (SMPL-H / X poses
    keep their 22 body joints, the hands zero)."""
    from uhc_tpu_torch.smpl.convert import smpl_to_qpose, smpl_to_qpose_ball

    conv = smpl_to_qpose_ball if ball else smpl_to_qpose
    out = {}
    for key, d in seqs.items():
        pose_aa = np.asarray(d["pose_aa"])
        if pose_aa.shape[-1] > 72:
            pose_aa = np.concatenate(
                [pose_aa[:, :66],
                 np.zeros((len(pose_aa), 6), pose_aa.dtype)], -1)
        qpos = conv(pose_aa, root_offset, d.get("trans"),
                    device=device).cpu().numpy()
        qpos[:, 2] += offset_z
        out[key] = qpos
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m uhc_tpu_torch.cli.smpl_rig_convert")
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--offset-z", type=float, default=0.0)
    p.add_argument("--ball", action="store_true",
                   help="ball-joint (quaternion) qpos layout")
    p.add_argument("--render", default=None,
                   help="write a headless gif/mp4 of the first sequence")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    import dataclasses

    from uhc_tpu_torch.data.dataset import load_motion_file
    from uhc_tpu_torch.device import resolve_device
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    dev = resolve_device(args.device)
    topo, model = load_fixture_humanoid()
    out = convert(load_motion_file(args.data), model.body_pos[0], args.ball,
                  args.offset_z, dev)
    if args.out.endswith(".npz"):
        np.savez(args.out, **out)
    else:
        with open(args.out, "wb") as f:
            pickle.dump(out, f)
    print(f"wrote {len(out)} qpos tracks -> {args.out}")

    if args.render:
        from uhc_tpu_torch.utils.visualizer import render_eval_result

        key = next(iter(out))
        t = (dataclasses.replace(topo, joint_kind="ball") if args.ball
             else topo)
        render_eval_result(t, model, out[key], out_path=args.render,
                           device=dev)
        print(f"rendered {key} -> {args.render}")
    return out


if __name__ == "__main__":
    main()
