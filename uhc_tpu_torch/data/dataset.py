"""Motion files and the device-resident expert library (PyTorch twin of
uhc_tpu.data.dataset: load_motion_file, build_expert_library).

Motion pickles are read with the joblib-free reader
(`uhc_tpu_torch.data.joblib_compat`), so neither joblib nor JAX is needed.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from uhc_tpu_torch.data import joblib_compat
from uhc_tpu_torch.envs.expert import qpos_fk
from uhc_tpu_torch.physics.model import Model, Topology
from uhc_tpu_torch.smpl.convert import smpl_to_qpose

EXPERT_KEYS = ["qpos", "qvel", "wbpos", "wbquat", "bquat", "body_com",
               "rlinv", "rlinv_local", "rangv", "bangvel", "ee_wpos",
               "ee_pos", "com"]


def load_motion_file(path: str) -> Dict[str, dict]:
    """Reference-format motion pkl -> {key: {pose_aa, trans, beta, ...}}."""
    raw = joblib_compat.load(path)
    if "pose_aa" in raw and not isinstance(raw["pose_aa"], dict):
        return {"standing_neutral": {"pose_aa": np.asarray(raw["pose_aa"]),
                                     "trans": None}}
    if "pose_aa" in raw and isinstance(raw["pose_aa"], dict):
        keys = list(raw["pose_aa"].keys())
        return {k: {f: (raw[f][k] if f in raw and k in raw[f] else None)
                    for f in ("pose_aa", "trans", "beta", "gender")}
                for k in keys}
    return raw


def build_expert_library(topo: Topology, model: Model,
                         seqs: Dict[str, dict], fps: float = 30.0,
                         max_len: Optional[int] = None):
    """Featurize, pad (repeating the last frame) and stack sequences:
    returns (lib dict of (S, Tmax, ...) tensors + per-sequence len and
    height bounds, list of keys), on the model's device."""
    dev = model.body_pos.device
    root_offset = model.body_pos[0].cpu().numpy()
    keys = list(seqs.keys())
    feats = []
    for k in keys:
        d = seqs[k]
        pose_aa = np.asarray(d["pose_aa"])
        trans = d.get("trans")
        if max_len is not None:
            pose_aa = pose_aa[:max_len]
            trans = None if trans is None else trans[:max_len]
        if pose_aa.shape[-1] > 72:   # SMPL-H poses: keep the body dofs
            pose_aa = np.concatenate(
                [pose_aa[:, :66], np.zeros((len(pose_aa), 6),
                                           pose_aa.dtype)], -1)
        qpos = smpl_to_qpose(pose_aa, root_offset, trans, device=dev)
        feats.append(qpos_fk(topo, model, qpos, fps))
    Tmax = max(f["len"] for f in feats)
    lib = {}
    for key in EXPERT_KEYS + ["head_pos"]:
        lib[key] = torch.stack([
            torch.cat([f[key], f[key][-1:].expand(
                (Tmax - f["len"],) + f[key].shape[1:])], 0)
            for f in feats])
    lib["len"] = torch.as_tensor([f["len"] for f in feats],
                                 dtype=torch.int64, device=dev)
    lib["height_lb"] = torch.stack([f["height_lb"] for f in feats])
    lib["head_height_lb"] = torch.stack([f["head_height_lb"] for f in feats])
    return lib, keys


def neutral_from_library(lib: dict):
    """Reset pose for reactive initialization: the first frame of the first
    sequence, at rest (the reference's standing_neutral.pkl is not in the
    repository)."""
    return lib["qpos"][0, 0].clone(), torch.zeros_like(lib["qvel"][0, 0])
