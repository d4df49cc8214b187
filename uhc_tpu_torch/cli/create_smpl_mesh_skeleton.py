"""SMPL mesh-skeleton model builder (PyTorch port's copy of
uhc_tpu.cli.create_smpl_mesh_skeleton, the twin of the reference's
scripts/create_smpl_mesh_skeleton.py).

Writes the zero-pose simulation model and a visualization scene of
--num-vis colour-coded humanoids (export_vis_string's equivalent,
smpl_robot.py:1490), both through `smpl.mjcf_export`, from the stand-in
humanoid (`smpl/fixture_humanoid.py`), shaped by real SMPL data at zero
betas when --smpl-data is given. Runs on the host; no card is needed.

Usage:
  python -m uhc_tpu_torch.cli.create_smpl_mesh_skeleton --out-dir models/ \
      [--gender neutral] [--smpl-data smpl.pkl] [--num-vis 2]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> tuple:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", required=True)
    p.add_argument("--gender", default="neutral")
    p.add_argument("--smpl-data", default=None,
                   help="SMPL model pkl/npz for exact zero-pose offsets")
    p.add_argument("--num-vis", type=int, default=2,
                   help="humanoid copies in the vis scene")
    args = p.parse_args(argv)

    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid
    from uhc_tpu_torch.smpl.mjcf_export import export_mjcf, export_vis_mjcf

    topo, model = load_fixture_humanoid()
    if args.smpl_data is not None:
        from uhc_tpu_torch.smpl.lbs import (load_smpl_data,
                                            vertex_body_assignment)
        from uhc_tpu_torch.smpl.robot import model_from_betas

        data = load_smpl_data(args.smpl_data)
        nb = int(np.asarray(data.shapedirs).shape[-1])
        model = model_from_betas(topo, model, data, np.zeros(nb, np.float32),
                                 vertex_body_assignment(data))

    os.makedirs(args.out_dir, exist_ok=True)
    sim_path = os.path.join(args.out_dir,
                            f"humanoid_smpl_{args.gender}_mesh_test.xml")
    vis_path = os.path.join(args.out_dir,
                            f"humanoid_smpl_{args.gender}_mesh_vis.xml")
    with open(sim_path, "w") as f:
        f.write(export_mjcf(topo, model))
    with open(vis_path, "w") as f:
        f.write(export_vis_mjcf(topo, model, num=args.num_vis))
    total_mass = float(np.sum(np.asarray(model.body_mass)))
    print(f"sim model -> {sim_path} (mass {total_mass:.2f} kg)")
    print(f"vis model -> {vis_path} ({args.num_vis} humanoids)")
    return sim_path, vis_path


if __name__ == "__main__":
    main()
