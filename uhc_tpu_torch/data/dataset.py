"""Motion files and the device-resident expert library (PyTorch twin of
uhc_tpu.data.dataset: load_motion_file, seq_beta_gender,
build_expert_library, build_shaped_library, build_dr_library).

Motion pickles are read with the joblib-free reader
(`uhc_tpu_torch.data.joblib_compat`), so neither joblib nor JAX is needed.
The shaped and domain-randomized libraries come with a model library: a
`Model` whose leaves carry a leading (S,) dim exactly where the sequences'
models differ (the JAX stacking rule; routing reads which leaves differ).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from uhc_tpu_torch.data import joblib_compat
from uhc_tpu_torch.envs.expert import qpos_fk
from uhc_tpu_torch.physics.model import (Model, Topology, model_from_numpy,
                                         model_to_numpy)
from uhc_tpu_torch.smpl.convert import smpl_to_qpose

EXPERT_KEYS = ["qpos", "qvel", "wbpos", "wbquat", "bquat", "body_com",
               "rlinv", "rlinv_local", "rangv", "bangvel", "ee_wpos",
               "ee_pos", "com"]
GENDER_NUM = {"neutral": 0.0, "male": 1.0, "female": 2.0}


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


def seq_beta_gender(d: dict, n_betas: int = 16):
    """First-frame beta padded / cut to n_betas, and the gender as a number
    (neutral 0, male 1, female 2)."""
    beta = d.get("beta")
    beta16 = np.zeros(n_betas, np.float32)
    if beta is not None:
        beta = np.asarray(beta, np.float32)
        if beta.ndim > 1:
            beta = beta[0]
        beta16[:min(len(beta), n_betas)] = beta[:n_betas]
    g = d.get("gender", "neutral")
    if isinstance(g, np.ndarray):
        g = g.item()
    if isinstance(g, bytes):
        g = g.decode("utf-8")
    if isinstance(g, str):
        g = GENDER_NUM.get(g, 0.0)
    return beta16, float(g)


def _featurize(topo: Topology, model: Model, d: dict, fps: float,
               max_len: Optional[int], converter=None,
               base_root_offset=None) -> dict:
    """One sequence through `model`'s FK; its qpos carries that model's
    root offset (Pelvis zero-pose position). With a `converter` (a widened
    tree such as masterfoot) the pose goes through the 24-body qpos with
    the base model's root offset and is remapped onto the new tree, its
    new joints at zero (reference humanoid_im.py:212 + the smpl_mujoco.py
    qpos remaps)."""
    dev = model.body_pos.device
    pose_aa = np.asarray(d["pose_aa"])
    trans = d.get("trans")
    if max_len is not None:
        pose_aa = pose_aa[:max_len]
        trans = None if trans is None else trans[:max_len]
    if converter is not None:
        qpos24 = smpl_to_qpose(_body_dofs(pose_aa), base_root_offset, trans,
                               device=dev)
        qpos = converter.qpos_smpl_2_new(qpos24)
    else:
        qpos = _pose_to_qpose(topo, model, pose_aa, trans, dev)
    return qpos_fk(topo, model, qpos, fps)


def _body_dofs(pose_aa: np.ndarray) -> np.ndarray:
    """A SMPL-H pose (156 dofs) cut to SMPL's 72: the 22 body joints and
    zero hands (the reference's smpl_to_qpose(model='smpl'))."""
    if pose_aa.shape[-1] <= 72:
        return pose_aa
    return np.concatenate(
        [pose_aa[:, :66], np.zeros((len(pose_aa), 6), pose_aa.dtype)], -1)


def _pose_to_qpose(topo: Topology, model: Model, pose_aa, trans, device):
    """The pose vector through the topology's converter: the 52-body
    SMPL-H tree takes all 156 dofs, a 72-dof SMPL clip on it gets flat
    hands (its two hand-root joints dropped, the finger chains zero); the
    24-body tree takes 72 dofs (a SMPL-H pose loses its hands)."""
    root_offset = model.body_pos[0].cpu().numpy()
    if topo.nbody == 52:
        from uhc_tpu_torch.smpl.smplh import smplh_to_qpose

        if pose_aa.shape[-1] == 72:
            pose_aa = np.concatenate(
                [pose_aa[:, :66],
                 np.zeros((len(pose_aa), 90), pose_aa.dtype)], -1)
        return smplh_to_qpose(pose_aa, root_offset, trans, device=device)
    return smpl_to_qpose(_body_dofs(pose_aa), root_offset, trans,
                         device=device)


def _stack_library(feats) -> dict:
    """Pad (repeating the last frame) and stack per-sequence features."""
    dev = feats[0]["qpos"].device
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
    return lib


def build_expert_library(topo: Topology, model: Model,
                         seqs: Dict[str, dict], fps: float = 30.0,
                         max_len: Optional[int] = None, converter=None,
                         base_root_offset=None):
    """Featurize, pad (repeating the last frame) and stack sequences:
    returns (lib dict of (S, Tmax, ...) tensors + per-sequence len and
    height bounds, list of keys), on the model's device. For a widened
    tree (masterfoot) pass its SMPLConverter and the 24-body model's root
    offset."""
    keys = list(seqs.keys())
    return _stack_library([_featurize(topo, model, seqs[k], fps, max_len,
                                      converter, base_root_offset)
                           for k in keys]), keys


def stack_models(models, device) -> Model:
    """Per-sequence models -> library: a leaf gets the leading (S,) dim
    only where the sequences differ."""
    nps = [model_to_numpy(m) for m in models]
    out = {}
    for f in dataclasses.fields(Model):
        vals = [n[f.name] for n in nps]
        same = all(np.array_equal(vals[0], v) for v in vals[1:])
        out[f.name] = torch.as_tensor(vals[0] if same else np.stack(vals),
                                      device=device)
    return Model(**out)


def build_shaped_library(topo: Topology, base_model: Model, seqs,
                         smpl_data, cfg, fps: float = 30.0,
                         max_len: Optional[int] = None,
                         rel_joint_lm: bool = True):
    """Shape-conditioned expert library (reference humanoid_im.py:154-180
    reset_robot): every sequence gets its own `Model` from its SMPL betas
    (`smpl.robot.model_from_betas`, with the anatomical joint ranges of
    `rel_joint_ranges` under rel_joint_lm), its expert features come from
    that model's FK, and its shape observation ([beta(16) if has_pca] +
    [gender] + [weight if has_weight] + [bone lengths if has_bone_length])
    is lib["shape_obs"].

    `smpl_data` is one SMPLData for every gender, or a dict of them by
    "neutral" / "male" / "female" (a missing gender maps to neutral).
    Returns (lib, keys, model_lib), all on base_model's device."""
    from uhc_tpu_torch.smpl.lbs import SMPLData, vertex_body_assignment
    from uhc_tpu_torch.smpl.robot import model_from_betas, rel_joint_ranges

    dev = base_model.body_pos.device
    if isinstance(smpl_data, SMPLData):
        by_gender = {0.0: smpl_data, 1.0: smpl_data, 2.0: smpl_data}
    else:
        fallback = smpl_data.get("neutral", next(iter(smpl_data.values())))
        by_gender = {g: smpl_data.get(n, fallback) for g, n in
                     ((0.0, "neutral"), (1.0, "male"), (2.0, "female"))}
    assign = {id(sd): vertex_body_assignment(sd)
              for sd in by_gender.values()}

    keys = list(seqs.keys())
    feats, models, betas, genders = [], [], [], []
    for k in keys:
        beta16, gender = seq_beta_gender(seqs[k], 16)
        sd = by_gender.get(gender, by_gender[0.0])
        n_b = int(sd.shapedirs.shape[-1])
        model_s = model_from_betas(topo, base_model, sd, beta16[:n_b],
                                   assign[id(sd)])
        if rel_joint_lm:
            model_s = dataclasses.replace(
                model_s, jnt_range=rel_joint_ranges(topo, model_s))
        model_s = model_from_numpy(model_to_numpy(model_s), dev)
        feats.append(_featurize(topo, model_s, seqs[k], fps, max_len))
        models.append(model_s)
        betas.append(beta16)
        genders.append(gender)

    lib = _stack_library(feats)
    model_lib = stack_models(models, dev)
    betas = np.stack(betas)
    genders = np.asarray(genders, np.float32)
    weight = np.asarray([float(np.sum(model_to_numpy(m)["body_mass"]))
                         for m in models], np.float32)
    bone_len = np.stack([np.linalg.norm(model_to_numpy(m)["body_pos"],
                                        axis=1) for m in models]
                        ).astype(np.float32)
    obs = []
    if cfg.has_pca:
        obs.append(betas)
    obs.append(genders[:, None])
    if cfg.has_weight:
        obs.append(weight[:, None])
    if cfg.has_bone_length:
        obs.append(bone_len)
    for name, v in (("beta", betas), ("gender", genders),
                    ("shape_obs", np.concatenate(obs, axis=1)),
                    ("weight", weight)):
        lib[name] = torch.as_tensor(v, device=dev)
    return lib, keys, model_lib


def build_dr_library(topo: Topology, model: Model, seqs,
                     n_variants: int = 8, friction_scale: float = 1.5,
                     contact_scale: float = 2.0, mass_scale: float = 1.15,
                     seed: int = 0, fps: float = 30.0,
                     max_len: Optional[int] = None):
    """Domain-randomized expert library: every sequence replicated
    `n_variants` times, variant-major (keys `k` for variant 0, `k@dr<v>`
    after), each replica with a model whose contact scalars (friction,
    stiffness, damping) and body masses / inertias are scaled
    log-uniformly within [1/scale, scale]; variant 0 is nominal. The
    factors come from numpy's default_rng(seed) in the JAX package's draw
    order (mass, friction, stiffness, damping), so both packages build the
    same library. Returns (lib, keys, model_lib)."""
    lib, keys0 = build_expert_library(topo, model, seqs, fps=fps,
                                      max_len=max_len)
    S, V = len(keys0), int(n_variants)
    if V < 2:
        raise ValueError("build_dr_library needs n_variants >= 2")
    lib = {k: torch.cat([v] * V, 0) for k, v in lib.items()}
    keys = list(keys0) + [f"{k}@dr{v}" for v in range(1, V) for k in keys0]
    rng = np.random.default_rng(seed)

    def factors(scale):
        f = np.exp(rng.uniform(np.log(1.0 / scale), np.log(scale),
                               size=(V,))).astype(np.float32)
        f[0] = 1.0
        return np.repeat(f, S)                       # (S*V,) variant-major

    m = model_to_numpy(model)
    dev = model.body_pos.device
    mass_f = factors(mass_scale)
    scaled = {k: float(m[k]) * factors(s) for k, s in (
        ("friction", friction_scale), ("contact_stiffness", contact_scale),
        ("contact_damping", contact_scale))}
    scaled["body_mass"] = mass_f[:, None] * m["body_mass"][None, :]
    scaled["body_inertia"] = (mass_f[:, None, None]
                              * m["body_inertia"][None, :, :])
    model_lib = dataclasses.replace(model, **{
        k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        for k, v in scaled.items()})
    return lib, keys, model_lib


def neutral_from_library(lib: dict):
    """Reset pose for reactive initialization: the first frame of the first
    sequence, at rest (the reference's standing_neutral.pkl is not in the
    repository)."""
    return lib["qpos"][0, 0].clone(), torch.zeros_like(lib["qvel"][0, 0])
