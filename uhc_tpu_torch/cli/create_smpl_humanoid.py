"""Generate a SMPL humanoid MJCF (PyTorch port's copy of
uhc_tpu.cli.create_smpl_humanoid, the twin of the reference's
scripts/create_smpl_humanoid.py).

The model arrays start from the stand-in humanoid
(`smpl/fixture_humanoid.py`), shaped by real SMPL data when --smpl-data
is given (its offsets at --betas); the variants (bigfoot, masterfoot,
smplh, smplx, ball) apply as array transforms, and the result is written
by `smpl.mjcf_export.export_mjcf`. Runs on the host; no card is needed.

Usage:
  python -m uhc_tpu_torch.cli.create_smpl_humanoid --out humanoid.xml \
      [--smpl-data smpl_neutral.pkl] [--betas 0.5,0,...] \
      [--variant none|bigfoot|masterfoot|smplh|smplx|ball]
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def build_model(variant: str = "none", smpl_data=None, betas=None):
    """(Topology, Model) of `variant` built from the stand-in humanoid
    (and the model file `smpl_data` at `betas` where given)."""
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    topo, model = load_fixture_humanoid()
    data = None
    if smpl_data is not None:
        betas = (np.array([float(x) for x in betas.split(",")], np.float32)
                 if betas else np.zeros(10, np.float32))
        if variant in ("smplh", "smplx"):
            from uhc_tpu_torch.smpl.lbs import load_smplh_data
            data = load_smplh_data(smpl_data)
        else:
            from uhc_tpu_torch.smpl.lbs import (load_smpl_data,
                                                vertex_body_assignment)
            from uhc_tpu_torch.smpl.robot import model_from_betas
            data = load_smpl_data(smpl_data)
            nb = int(np.asarray(data.shapedirs).shape[-1])
            model = model_from_betas(topo, model, data, betas[:nb],
                                     vertex_body_assignment(data))
    if variant == "bigfoot":
        from uhc_tpu_torch.smpl.masterfoot import bigfoot_model
        model = bigfoot_model(topo, model)
    elif variant == "masterfoot":
        from uhc_tpu_torch.smpl.masterfoot import masterfoot_model
        topo, model, _ = masterfoot_model(topo, model, 30.0)
    elif variant in ("smplh", "smplx"):
        from uhc_tpu_torch.smpl import smplh as SH
        if data is not None:
            model = (SH.smplh_model_from_data if variant == "smplh"
                     else SH.smplx_model_from_data)(topo, model, data)
        else:
            model = (SH.smplh_model if variant == "smplh"
                     else SH.smplx_model)(topo, model)
        topo = (SH.smplh_topology() if variant == "smplh"
                else SH.smplx_topology())
    elif variant == "ball":
        topo = dataclasses.replace(topo, joint_kind="ball")
    return topo, model


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--smpl-data", default=None,
                   help="SMPL(-H) model pkl/npz for exact shaped offsets")
    p.add_argument("--betas", default=None,
                   help="comma-separated shape coefficients")
    p.add_argument("--variant", default="none",
                   choices=["none", "bigfoot", "masterfoot", "smplh",
                            "smplx", "ball"])
    args = p.parse_args(argv)

    from uhc_tpu_torch.smpl.mjcf_export import export_mjcf

    topo, model = build_model(args.variant, args.smpl_data, args.betas)
    xml = export_mjcf(topo, model, name=os.path.splitext(
        os.path.basename(args.out))[0])
    with open(args.out, "w") as f:
        f.write(xml)
    print(f"wrote {args.out} ({topo.nbody} bodies, nq={topo.nq})")
    return args.out


if __name__ == "__main__":
    main()
