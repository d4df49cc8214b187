"""Replay recorded rollout takes (PyTorch twin of uhc_tpu.cli.replay).

Reads the per-sequence trajectory pickle that `cli/eval --dump` writes
(either package's; through `data/joblib_compat`, so joblib is not needed),
lists the takes, writes one take's arrays to an .npz, and renders
pred-vs-gt skeleton animations of one take or all of them (matplotlib), or
opens the interactive viewer. Host code: the dump already holds the
joint positions, so nothing runs on a card.

    python -m uhc_tpu_torch.cli.replay --data eval_dump.pkl --list
    python -m uhc_tpu_torch.cli.replay --data eval_dump.pkl --take KEY \\
        --dump-states states.npz --no-render
    python -m uhc_tpu_torch.cli.replay --data eval_dump.pkl --take KEY \\
        --out replay.gif
    python -m uhc_tpu_torch.cli.replay --data eval_dump.pkl --all \\
        --out-dir vis/
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def dump_states(take: dict, path: str) -> list:
    """Write a take's array fields (pred / gt joint positions and qpos)
    to an .npz; returns their names."""
    arrays = {k: np.asarray(v) for k, v in take.items()
              if hasattr(v, "__len__") and not isinstance(v, str)}
    np.savez(path, **arrays)
    return sorted(arrays)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m uhc_tpu_torch.cli.replay",
                                description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True,
                   help="trajectory pkl from cli/eval --dump")
    p.add_argument("--take", default=None, help="sequence key to replay")
    p.add_argument("--all", action="store_true",
                   help="render every take")
    p.add_argument("--list", action="store_true", dest="list_takes",
                   help="print take keys and lengths, then exit")
    p.add_argument("--out", default="replay.gif")
    p.add_argument("--out-dir", default="replay_vis")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--dump-states", default=None, metavar="NPZ",
                   help="also write the take's raw arrays (pred/gt joint "
                        "positions, qpos if present) to an .npz")
    p.add_argument("--no-render", action="store_true",
                   help="with --dump-states: write the arrays only")
    p.add_argument("--interactive", action="store_true",
                   help="open the interactive viewer (matplotlib window: "
                        "space pause, left/right step, s reverse, q next "
                        "take, w/e first/last, g loop, d/f speed, "
                        "t screenshot, v record); needs a GUI backend")
    args = p.parse_args(argv)

    from uhc_tpu_torch.data import joblib_compat

    takes = joblib_compat.load(args.data)
    if args.list_takes:
        for k, v in takes.items():
            print(f"{k}: {len(v['pred_jpos'])} frames, "
                  f"percent={v.get('percent', float('nan')):.2f}, "
                  f"fail_safe={v.get('fail_safe')}")
        return takes

    if args.interactive:
        from uhc_tpu_torch.utils.interactive import InteractiveViewer

        viewer = InteractiveViewer(takes, fps=args.fps)
        viewer.show()
        return takes

    from uhc_tpu_torch.utils.visualizer import render_comparison

    if args.all:
        os.makedirs(args.out_dir, exist_ok=True)
        ext = os.path.splitext(args.out)[1] or ".gif"
        for k, v in takes.items():
            out = os.path.join(args.out_dir, f"{k}{ext}")
            path = render_comparison(v["pred_jpos"], v.get("gt_jpos"),
                                     out_path=out, fps=args.fps,
                                     stride=args.stride)
            print(f"{k} -> {path}")
        return takes

    key = args.take if args.take is not None else next(iter(takes))
    if key not in takes:
        raise SystemExit(f"take {key!r} not in {sorted(takes)}")
    v = takes[key]
    if args.dump_states:
        dump_states(v, args.dump_states)
        print(f"{key} states -> {args.dump_states}")
        if args.no_render:
            return takes
    path = render_comparison(v["pred_jpos"], v.get("gt_jpos"),
                             out_path=args.out, fps=args.fps,
                             stride=args.stride)
    print(f"{key} -> {path}")
    return takes


if __name__ == "__main__":
    main()
