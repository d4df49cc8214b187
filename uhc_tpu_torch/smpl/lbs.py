"""SMPL linear blend skinning (PyTorch twin of uhc_tpu.smpl.lbs).

* shape blendshapes + joint regression: betas -> zero-pose joints and
  vertices, and the per-body offsets of the MuJoCo tree they give;
* full LBS: (pose_aa, betas, trans) -> posed vertices, for the vertex
  penetration / skate metrics;
* per-body vertex assignment by argmax skinning weight.

Model data loads from the standard SMPL .pkl / .npz files when a user has
them (they are not redistributable). Without them,
`synthetic_smpl_data_like` builds SMPL-shaped blendshapes around a given
skeleton from a numpy seed; `synthetic_smpl_data` is the older random
stand-in used by tests. Both are pure numpy, so they equal the JAX
package's to the bit. The 24-joint SMPL family only (SMPL-H / SMPL-X
loading is not ported).
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Optional

import numpy as np
import torch

from uhc_tpu_torch.maths import quat_from_rotvec, quat_mul, quat_rotate
from uhc_tpu_torch.smpl.constants import (MUJOCO_2_SMPL, MUJOCO_PARENTS,
                                          SMPL_2_MUJOCO, SMPL_PARENTS)


@dataclasses.dataclass(frozen=True)
class SMPLData:
    """Static SMPL model arrays (one gender), float32 tensors."""

    v_template: Any   # (V, 3)
    shapedirs: Any    # (V, 3, n_betas)
    j_regressor: Any  # (24, V)
    weights: Any      # (V, 24) LBS skinning weights


def _smpl_data(v, sd, jr, w) -> SMPLData:
    return SMPLData(*(torch.as_tensor(np.asarray(x, np.float32))
                      for x in (v, sd, jr, w)))


def load_smpl_data(path: str, n_betas: int = 16) -> SMPLData:
    """A SMPL model file (.pkl or .npz) -> SMPLData."""
    if path.endswith(".npz"):
        d = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="latin1")
    jr = d["J_regressor"]
    jr = np.asarray(jr.todense() if hasattr(jr, "todense") else jr)[:24]
    return _smpl_data(np.asarray(d["v_template"]),
                      np.asarray(d["shapedirs"])[:, :, :n_betas], jr,
                      np.asarray(d["weights"])[:, :24])


def synthetic_smpl_data(rng_seed: int = 0, V: int = 512, n_betas: int = 16,
                        nj: int = 24) -> SMPLData:
    """Random stand-in with SMPL's array shapes (tests only: its regressed
    joints all sit near the mean vertex)."""
    rng = np.random.default_rng(rng_seed)
    v = rng.normal(scale=0.3, size=(V, 3)).astype(np.float32)
    v[:, 2] += 0.3
    sd = rng.normal(scale=0.01, size=(V, 3, n_betas)).astype(np.float32)
    jr = np.abs(rng.normal(size=(nj, V))).astype(np.float32)
    jr /= jr.sum(1, keepdims=True)
    w = np.abs(rng.normal(size=(V, nj))).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    return _smpl_data(v, sd, jr, w)


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def synthetic_smpl_data_like(topo, base_model, rng_seed: int = 0,
                             n_betas: int = 16, bone_sigma: float = 0.02,
                             spread_sigma: float = 0.06,
                             vert_radius: float = 0.06) -> SMPLData:
    """Synthetic SMPL stand-in consistent with a skeleton: at betas = 0 the
    regressed joints are `base_model`'s zero-pose joints; each beta mode
    moves bone vectors smoothly down the kinematic chain (±bone_sigma per
    bone per unit beta) and spreads each body's four vertices (volume,
    hence mass and hull scale). These are not real SMPL bodies."""
    nj = topo.nbody
    if nj != 24:
        raise NotImplementedError("only the 24-joint SMPL family is ported")
    rng = np.random.default_rng(rng_seed)

    # absolute zero-pose joints: mujoco order, then scattered to SMPL order
    bp = _np64(base_model.body_pos)
    abs_j = np.zeros_like(bp)
    for i in range(nj):
        p = topo.parents[i]
        abs_j[i] = bp[i] + (abs_j[p] if p >= 0 else 0.0)
    native = np.zeros_like(abs_j)
    native[np.asarray(SMPL_2_MUJOCO)] = abs_j

    # 4 tetrahedral vertices per joint: an exact regressor and hulls
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                   np.float64) * (vert_radius / np.sqrt(3.0))
    V = 4 * nj
    v = (native[:, None, :] + tet[None]).reshape(V, 3)
    jr = np.zeros((nj, V))
    w = np.zeros((V, nj))
    for k in range(nj):
        jr[k, 4 * k:4 * k + 4] = 0.25
        w[4 * k:4 * k + 4, k] = 1.0

    # beta modes: a random walk of bone displacement down the SMPL tree
    # (children inherit their parent's) + per-joint isotropic spread
    d = np.zeros((n_betas, nj, 3))
    for m in range(n_betas):
        for k in range(1, nj):
            p = int(SMPL_PARENTS[k])
            d[m, k] = d[m, p] + rng.normal(scale=bone_sigma, size=3)
    e = rng.normal(scale=spread_sigma, size=(n_betas, nj))
    sdirs = np.zeros((V, 3, n_betas))
    for k in range(nj):
        for t in range(4):
            i = 4 * k + t
            sdirs[i] = (d[:, k, :] + tet[t][None, :] * e[:, k:k + 1]).T
    return _smpl_data(v, sdirs, jr, w)


def _parents(nj: int) -> np.ndarray:
    if nj != 24:
        raise NotImplementedError(f"{nj}-joint model data: only the "
                                  "24-joint SMPL family is ported")
    return SMPL_PARENTS


def shaped_vertices(data: SMPLData, betas) -> torch.Tensor:
    """Zero-pose vertices (V, 3) for shape coefficients betas (n_betas,)."""
    betas = torch.as_tensor(betas, dtype=torch.float32)
    nb = betas.shape[-1]
    return data.v_template + torch.einsum(
        "vcb,b->vc", data.shapedirs[:, :, :nb], betas)


def shaped_joints(data: SMPLData, betas) -> torch.Tensor:
    """(24, 3) zero-pose joints in SMPL bone order."""
    return data.j_regressor @ shaped_vertices(data, betas)


def lbs(data: SMPLData, pose_aa, betas, trans: Optional[Any] = None):
    """Linear blend skinning over a batch of frames.

    pose_aa: (..., 24, 3) axis-angle in SMPL bone order; betas:
    (n_betas,); trans: (..., 3). Returns (vertices (..., V, 3), joints
    (..., 24, 3)) in world space."""
    pose_aa = torch.as_tensor(pose_aa, dtype=torch.float32)
    verts0 = shaped_vertices(data, betas)
    joints0 = data.j_regressor @ verts0
    parents = _parents(joints0.shape[0])
    quats = quat_from_rotvec(pose_aa)                 # (..., nj, 4)
    lead = quats.shape[:-2]
    gquat = [quats[..., 0, :]]
    gpos = [joints0[0].expand(lead + (3,))]
    for i in range(1, joints0.shape[0]):
        p = int(parents[i])
        gquat.append(quat_mul(gquat[p], quats[..., i, :]))
        gpos.append(gpos[p] + quat_rotate(gquat[p], joints0[i] - joints0[p]))
    gquat = torch.stack(gquat, -2)
    gpos = torch.stack(gpos, -2)
    # x' = Σ_j w_j (R_j (x - j0_j) + g_j)
    rel = verts0[:, None, :] - joints0[None, :, :]              # (V, nj, 3)
    moved = (quat_rotate(gquat[..., None, :, :], rel)
             + gpos[..., None, :, :])                    # (..., V, nj, 3)
    verts = torch.einsum("vj,...vjc->...vc", data.weights, moved)
    if trans is not None:
        trans = torch.as_tensor(trans, dtype=torch.float32)[..., None, :]
        verts = verts + trans
        gpos = gpos + trans
    return verts, gpos


def vertex_body_assignment(data: SMPLData) -> np.ndarray:
    """Vertex -> body by argmax skinning weight, in MuJoCo body order."""
    a = np.argmax(np.asarray(data.weights), axis=1)
    return np.asarray(MUJOCO_2_SMPL)[a].astype(np.int32)


def mujoco_offsets_from_betas(data: SMPLData, betas):
    """Per-body local offsets (24, 3) in MuJoCo order and the root joint
    for a body shape: offsets[i] = joint_i - joint_parent(i)."""
    joints = shaped_joints(data, betas)[torch.as_tensor(
        SMPL_2_MUJOCO.astype(np.int64))]
    parents = torch.as_tensor(MUJOCO_PARENTS.astype(np.int64))
    par = joints[torch.clamp(parents, min=0)]
    off = joints - torch.where((parents >= 0)[:, None], par,
                               torch.zeros_like(par))
    return off, joints[0]
