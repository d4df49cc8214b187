"""Offline AMASS ETL (PyTorch twin of uhc_tpu.data.process_amass).

Stage 1 (`read_amass_dir`): walk an AMASS directory tree of npz mocap
files into a flat {key -> raw dict} db.

Stage 2 (`process_amass_db`): per sequence, resample mocap_framerate ->
30 Hz, apply the occlusion list (drop irrecoverable sequences, clip
sitting / airborne ones to their first-issue frame), drop sequences
shorter than 10 frames, ground the trajectory with
`fix_height_smpl_vanilla` (subtract the min vertex z of the first frame,
the port's LBS on `device`), convert axis-angle to the 6d rotation
representation (the first two matrix columns, column-major, on `device`)
and split train / test / valid by AMASS corpus.

The output pickles load through `uhc_tpu_torch.data.dataset.
load_motion_file`, whose library builder cuts 156-wide SMPL-H poses to
SMPL's 72.

Usage:
  python -m uhc_tpu_torch.data.process_amass --dir AMASS_ROOT
      [--out_dir out] [--occlusion OCC.pkl] [--smpl SMPL.pkl]
      [--device cpu]
"""
from __future__ import annotations

import dataclasses
import glob
import os
import os.path as osp
import pickle
from typing import Dict, Iterable, Optional

import numpy as np
import torch

TARGET_FR = 30

AMASS_SPLITS = {
    "vald": ["HumanEva", "MPI_HDM05", "SFU", "MPI_mosh"],
    "test": ["Transitions_mocap", "SSM_synced"],
    "train": ["CMU", "MPI_Limits", "TotalCapture", "Eyes_Japan_Dataset",
              "KIT", "BML", "EKUT", "TCD_handMocap", "BMLhandball",
              "DanceDB", "ACCAD", "BMLmovi", "BioMotionLab", "Eyes",
              "DFaust"],
}
AMASS_SPLIT_DICT = {d: k for k, v in AMASS_SPLITS.items() for d in v}


def read_amass_dir(root: str, sequences: Optional[Iterable[str]] = None
                   ) -> Dict[str, dict]:
    """{corpus_subject_action -> dict(np.load(...))}, skipping shape.npz
    files."""
    if sequences is None:
        sequences = sorted(
            x for x in os.listdir(root) if osp.isdir(osp.join(root, x)))
    db = {}
    for seq_name in sequences:
        for fname in sorted(glob.glob(osp.join(root, seq_name, "*", "*.npz"))):
            if fname.endswith("shape.npz"):
                continue
            subject = osp.basename(osp.dirname(fname))
            action = osp.basename(fname)[:-4]
            db[f"{seq_name}_{subject}_{action}"] = dict(np.load(fname))
    return db


def count_consec(idx: np.ndarray):
    """Lengths of the runs of consecutive indices."""
    lst = np.asarray(idx).reshape(-1)
    if lst.size == 0:
        return [0]
    consec = [1]
    for x, y in zip(lst, lst[1:]):
        if x == y - 1:
            consec[-1] += 1
        else:
            consec.append(1)
    return consec


def _on(smpl_data, device):
    return type(smpl_data)(*(t.to(device) for t in
                             dataclasses.astuple(smpl_data)))


def fix_height_smpl_vanilla(smpl_data, pose_aa, trans, betas, *, device):
    """Ground the sequence: subtract the first frame's min vertex z (the
    24-joint SMPL body of the pose; SMPL-H / X share its first 22)."""
    from uhc_tpu_torch.smpl.lbs import lbs

    n_betas = smpl_data.shapedirs.shape[-1]
    b = np.zeros(n_betas, np.float32)
    b[:min(len(betas), n_betas)] = betas[:n_betas]
    p = np.zeros(72, np.float32)
    p[:min(pose_aa.shape[-1], 72)] = pose_aa[0][:72]
    dev = torch.device(device)
    verts, _ = lbs(_on(smpl_data, dev),
                   torch.as_tensor(p.reshape(24, 3), device=dev),
                   torch.as_tensor(b, device=dev),
                   torch.as_tensor(np.asarray(trans[0], np.float32),
                                   device=dev))
    gp = float(verts[:, 2].min())
    out = np.array(trans, copy=True)
    out[:, 2] -= gp
    return out


def aa_to_orth6d(pose_aa: np.ndarray, *, device) -> np.ndarray:
    """(T, J*3) axis-angle -> (T, J, 6): each rotation matrix's first two
    COLUMNS, one after the other."""
    from uhc_tpu_torch.maths import quat_from_rotvec, quat_to_mat

    aa = torch.as_tensor(np.asarray(pose_aa), dtype=torch.float32,
                         device=device).reshape(pose_aa.shape[0], -1, 3)
    mats = quat_to_mat(quat_from_rotvec(aa))
    six = mats[..., :, :2].transpose(-1, -2).reshape(aa.shape[0], -1, 6)
    return six.cpu().numpy()


def process_amass_db(raw_db: Dict[str, dict],
                     occlusion: Optional[Dict[str, dict]] = None,
                     smpl_data=None, target_fr: int = TARGET_FR, *,
                     device) -> Dict[str, dict]:
    """Raw npz dicts -> {key -> {pose_aa, pose_6d, trans, beta, seq_name,
    gender}} at 30 Hz; keys "0-<corpus>_<subject>_<action>"."""
    occlusion = occlusion or {}
    out = {}
    for k, v in raw_db.items():
        key = "0-" + k
        fr = int(v.get("mocap_framerate", target_fr))
        skip = max(int(fr / target_fr), 1)
        pose = np.asarray(v["poses"])[::skip]
        trans = np.asarray(v["trans"])[::skip]
        bound = pose.shape[0]
        if key in occlusion:
            issue = occlusion[key].get("issue")
            if issue in ("sitting", "airborne") and "idxes" in occlusion[key]:
                bound = occlusion[key]["idxes"][0]
                if bound < 10:
                    continue
            else:
                continue
        pose, trans = pose[:bound], trans[:bound]
        if pose.shape[0] < 10:
            continue
        betas = np.asarray(v["betas"]).reshape(-1)
        if smpl_data is not None:
            trans = fix_height_smpl_vanilla(smpl_data, pose, trans, betas,
                                            device=device)
        gender = v.get("gender", "neutral")
        if isinstance(gender, np.ndarray):
            gender = gender.item()
        if isinstance(gender, bytes):
            gender = gender.decode("utf-8")
        out[key] = {
            "pose_aa": pose.astype(np.float32),
            "pose_6d": aa_to_orth6d(pose, device=device).astype(np.float32),
            "trans": trans.astype(np.float32),
            "beta": betas[:16].astype(np.float32),
            "seq_name": key,
            "gender": gender,
        }
    return out


def split_amass_db(db: Dict[str, dict]) -> Dict[str, Dict[str, dict]]:
    """Split by the AMASS corpus name after the "0-" prefix (a corpus with
    an underscore in its name is matched by prefix; unknown ones go to
    train)."""
    splits: Dict[str, Dict[str, dict]] = {"train": {}, "test": {}, "vald": {}}
    for k, v in db.items():
        corpus = k.split("-", 1)[-1].split("_")[0]
        split = AMASS_SPLIT_DICT.get(corpus)
        if split is None:
            for name, s in AMASS_SPLIT_DICT.items():
                if k.split("-", 1)[-1].startswith(name):
                    split = s
                    break
        splits[split or "train"][k] = v
    return splits


def save_db(db: Dict[str, dict], path: str):
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(db, f)


def split_paths(out_dir: str) -> Dict[str, str]:
    """Each split's output pickle."""
    return {s: osp.join(out_dir, f"amass_copycat_take5_{s}.pkl")
            for s in ("train", "test", "vald")}


def main(argv=None):
    import argparse

    from uhc_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(prog="python -m "
                                "uhc_tpu_torch.data.process_amass")
    p.add_argument("--dir", required=True, help="AMASS root directory")
    p.add_argument("--out_dir", default="out")
    p.add_argument("--occlusion", default=None,
                   help="amass_copycat_occlusion_v2.pkl path")
    p.add_argument("--smpl", default=None, help="SMPL model pkl / npz for "
                   "ground-height fixing (omit to skip)")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    raw = read_amass_dir(args.dir)
    occ = None
    if args.occlusion:
        from uhc_tpu_torch.data import joblib_compat

        occ = joblib_compat.load(args.occlusion)
    smpl_data = None
    if args.smpl:
        from uhc_tpu_torch.smpl.lbs import load_smpl_data

        smpl_data = load_smpl_data(args.smpl)
    db = process_amass_db(raw, occ, smpl_data, device=dev)
    paths = split_paths(args.out_dir)
    for split, d in split_amass_db(db).items():
        save_db(d, paths[split])
        print(split, len(d))
    return paths


if __name__ == "__main__":
    main()
