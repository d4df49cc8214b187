"""Human3.6M conversion CLI (PyTorch-package twin of
uhc_tpu.cli.convert_h36m; host numpy).

Converts extracted H36M D3_Angles pose dicts to 30 Hz MuJoCo qpos
trajectories and (optionally) writes the generated H36M humanoid MJCF.

Usage:
  python -m uhc_tpu_torch.cli.convert_h36m --data data_pose_h36m.p \\
      --out data_qpos_h36m.p [--mocap-fr 50] [--write-model h36m.xml]
  python -m uhc_tpu_torch.cli.convert_h36m --write-model h36m.xml
"""
from __future__ import annotations

import argparse
import os
import pickle


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m uhc_tpu_torch.cli.convert_h36m")
    p.add_argument("--data", default=None,
                   help="extracted {subject: {action: poses}} pickle")
    p.add_argument("--out", default=None)
    p.add_argument("--mocap-fr", type=int, default=50)
    p.add_argument("--dt", type=float, default=1 / 30)
    p.add_argument("--write-model", default=None, metavar="XML",
                   help="also write the H36M capsule humanoid MJCF")
    args = p.parse_args(argv)

    from uhc_tpu_torch.data import h36m

    if args.write_model:
        with open(args.write_model, "w") as f:
            f.write(h36m.h36m_mjcf_string())
        print(f"h36m humanoid ({h36m.h36m_nq()} qpos) -> "
              f"{args.write_model}")

    out = None
    if args.data:
        with open(os.path.expanduser(args.data), "rb") as f:
            orig = pickle.load(f)
        out = h36m.convert_h36m_dict(orig, mocap_fr=args.mocap_fr,
                                     dt=args.dt)
        n = sum(len(v) for v in out.values())
        if args.out:
            with open(os.path.expanduser(args.out), "wb") as f:
                pickle.dump(out, f)
            print(f"{n} sequences -> {args.out}")
        else:
            for s, acts in out.items():
                for a, q in acts.items():
                    print(f"{s}/{a}: qpos {q.shape}")
    return out


if __name__ == "__main__":
    main()
