"""Headless SMPL-rig renderer (PyTorch twin of
uhc_tpu.cli.render_smpl_rig), on the stand-in humanoid
(`smpl/fixture_humanoid.py`); the JAX script reads the reference MJCF,
which is not in the repository.

pose -> qpos (`smpl_to_qpose`, SMPL-H / X poses cut to their 22 body
joints as cli/smpl_rig_convert cuts them) -> the env's FK on the device ->
`utils.visualizer.render_comparison` (matplotlib), one file per clip.

Usage:
  python -m uhc_tpu_torch.cli.render_smpl_rig --data <motion pkl> \\
      --output-dir renders/ [--max-seqs 3] [--max-frames 150] [--fmt gif] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m uhc_tpu_torch.cli.render_smpl_rig")
    p.add_argument("--data", required=True, help="motion pkl (pose_aa + "
                   "trans per sequence)")
    p.add_argument("--output-dir", default="renders")
    p.add_argument("--max-seqs", type=int, default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--fmt", default="gif", choices=("gif", "mp4", "png"))
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    import numpy as np

    from uhc_tpu_torch.data.dataset import load_motion_file
    from uhc_tpu_torch.device import resolve_device
    from uhc_tpu_torch.cli.smpl_rig_convert import convert
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid
    from uhc_tpu_torch.utils.visualizer import render_eval_result

    dev = resolve_device(args.device)
    topo, model = load_fixture_humanoid()
    seqs = load_motion_file(args.data)
    os.makedirs(args.output_dir, exist_ok=True)

    paths = {}
    for key, seq in seqs.items():
        if args.max_seqs is not None and len(paths) >= args.max_seqs:
            break
        pose_aa = np.asarray(seq["pose_aa"], np.float32)
        trans = seq.get("trans")
        trans = np.asarray(np.zeros((len(pose_aa), 3)) if trans is None
                           else trans, np.float32)
        if args.max_frames:
            pose_aa, trans = (pose_aa[:args.max_frames],
                              trans[:args.max_frames])
        qpos = convert({key: {"pose_aa": pose_aa, "trans": trans}},
                       model.body_pos[0], False, 0.0, dev)[key]
        safe = key.replace("/", "_").replace(" ", "_")
        out = os.path.join(args.output_dir, f"{safe}.{args.fmt}")
        paths[key] = render_eval_result(topo, model, qpos, out_path=out,
                                        stride=args.stride, device=dev)
        print(f"{key}: {len(qpos)} frames -> {paths[key]}")
    return paths


if __name__ == "__main__":
    main()
