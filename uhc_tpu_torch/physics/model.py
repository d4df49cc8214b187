"""Humanoid model containers (PyTorch twin of uhc_tpu.physics.model).

* `Topology` — static tree structure as plain Python (dof addressing,
  ancestor masks, depth levels).
* `Model` — a dataclass of per-body / per-dof arrays with the JAX package's
  field names. The MJCF loader fills it with numpy arrays;
  `model_from_numpy` turns any such container into float32 tensors on a
  device, `model_to_numpy` goes back.
* A model *library* is a `Model` whose leaves carry a leading (S,) dim
  where sequences differ (per-shape or domain-randomized models): the
  leaves that differ per sequence get the dim, the rest stay shared.
  `env_models(lib, seq_idx)` picks each env's model; `model_per_env`
  gives every leaf a leading env dim (shared leaves as expanded views, no
  copy), the one form the batched engine reads.

Layouts match MuJoCo: qpos = [root xyz, root quat wxyz, 23 × euler z-y-x]
(76), qvel = [root linvel (world), root angvel (root-local), 69 joint
rates] (75).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static tree structure."""

    nbody: int
    parents: tuple  # len nbody, -1 for root
    body_names: tuple
    joint_kind: str = "euler"

    @property
    def nv(self) -> int:
        return 6 + 3 * (self.nbody - 1)

    @property
    def nq(self) -> int:
        return 7 + 3 * (self.nbody - 1)

    @property
    def ndof(self) -> int:
        return 3 * (self.nbody - 1)

    def dof_body(self) -> np.ndarray:
        """Body index owning each dof (first 6 -> root)."""
        out = [0] * 6
        for i in range(1, self.nbody):
            out += [i] * 3
        return np.array(out, np.int64)

    def ancestor_mask(self) -> np.ndarray:
        """(nbody, nv) 1.0 where dof j is in the kinematic chain of body i."""
        mask = np.zeros((self.nbody, self.nv), np.float32)
        for i in range(self.nbody):
            b = i
            while b != -1:
                if b == 0:
                    mask[i, 0:6] = 1.0
                else:
                    s = 6 + 3 * (b - 1)
                    mask[i, s:s + 3] = 1.0
                b = self.parents[b]
        return mask

    def levels(self):
        """Bodies grouped by tree depth (root excluded): list of
        (body_idx, parent_idx) int64 arrays, shallowest first."""
        depth = [0] * self.nbody
        for i in range(1, self.nbody):
            depth[i] = depth[self.parents[i]] + 1
        out = []
        for d in range(1, max(depth) + 1):
            idx = np.array([i for i in range(self.nbody) if depth[i] == d],
                           np.int64)
            out.append((idx, np.array([self.parents[i] for i in idx],
                                      np.int64)))
        return out

    def subtree_end(self) -> np.ndarray:
        """For a depth-first body order: body b's subtree is the index range
        [b, subtree_end[b]). Raises if the order is not depth-first."""
        end = np.arange(1, self.nbody + 1)
        for i in range(self.nbody - 1, 0, -1):
            p = self.parents[i]
            end[p] = max(end[p], end[i])
        for b in range(self.nbody):
            for c in range(b + 1, end[b]):
                a = c
                while a not in (-1, b):
                    a = self.parents[a]
                if a != b:
                    raise ValueError("body order is not depth-first")
        return end.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Model:
    """Array data of the humanoid (same fields as the JAX Model)."""

    body_pos: Any      # (nbody,3) offset from parent frame
    body_ipos: Any     # (nbody,3) COM in body frame
    body_mass: Any     # (nbody,)
    body_inertia: Any  # (nbody,3) principal moments
    body_iquat: Any    # (nbody,4) principal frame orientation in body frame
    armature: Any      # (nv,)
    jkp: Any           # (ndof,)
    jkd: Any           # (ndof,)
    torque_lim: Any    # (ndof,)
    a_scale: Any       # (ndof,)
    jnt_range: Any     # (ndof,2)
    contact_point: Any  # (nb, K, 3)
    contact_mask: Any   # (nb, K)
    sc_point: Any       # (nb, SC, 3)
    sc_radius: Any      # (nb,)
    friction: Any
    contact_stiffness: Any
    contact_damping: Any
    contact_depth_cap: Any
    contact_vreg: Any
    gravity: Any        # (3,)
    dt: Any

    def nbody(self):
        return self.body_pos.shape[-2]


# base (unbatched) ndim of every Model leaf
MODEL_BASE_NDIM = {
    "body_pos": 2, "body_ipos": 2, "body_mass": 1, "body_inertia": 2,
    "body_iquat": 2, "armature": 1, "jkp": 1, "jkd": 1, "torque_lim": 1,
    "a_scale": 1, "jnt_range": 2, "contact_point": 3, "contact_mask": 2,
    "sc_point": 3, "sc_radius": 1,
    "friction": 0, "contact_stiffness": 0, "contact_damping": 0,
    "contact_depth_cap": 0, "contact_vreg": 0, "gravity": 1, "dt": 0,
}


def model_from_numpy(m, device="cuda", dtype=torch.float32) -> Model:
    """Any container with the Model field names (this Model, the JAX
    Model, or a dict; a shared model or a library) -> Model of tensors on
    `device`."""
    get = m.get if isinstance(m, dict) else (lambda k: getattr(m, k))
    fields = {}
    for f in dataclasses.fields(Model):
        v = np.asarray(get(f.name), np.float32)
        if v.ndim not in (MODEL_BASE_NDIM[f.name],
                          MODEL_BASE_NDIM[f.name] + 1):
            raise ValueError(f"Model.{f.name}: expected ndim "
                             f"{MODEL_BASE_NDIM[f.name]} (shared) or "
                             f"{MODEL_BASE_NDIM[f.name] + 1} (library), "
                             f"got {v.ndim}")
        fields[f.name] = torch.as_tensor(v, dtype=dtype, device=device)
    return Model(**fields)


def _batched(v, name: str) -> bool:
    return np.ndim(v) > MODEL_BASE_NDIM[name]


def model_batch_axes(m) -> dict:
    """{leaf name: 0 if it carries a leading library/env dim, else None}."""
    return {f.name: 0 if _batched(getattr(m, f.name), f.name) else None
            for f in dataclasses.fields(Model)}


def model_is_batched(m) -> bool:
    return any(_batched(getattr(m, f.name), f.name)
               for f in dataclasses.fields(Model))


def model_gather(lib: Model, idx) -> Model:
    """Index a model library by sequence index (scalar or (B,)); shared
    leaves pass through."""
    return Model(**{f.name: (getattr(lib, f.name)[idx]
                             if _batched(getattr(lib, f.name), f.name)
                             else getattr(lib, f.name))
                    for f in dataclasses.fields(Model)})


def env_models(model: Model, seq_idx=None) -> Model:
    """The model each env simulates: a library gathered by the envs'
    seq_idx (B,), a shared model as it is."""
    if not model_is_batched(model):
        return model
    if seq_idx is None:
        raise ValueError("a model library needs seq_idx")
    return model_gather(model, torch.as_tensor(seq_idx).long())


def model_per_env(m: Model, B: int) -> Model:
    """Every leaf with a leading (B,) env dim: shared leaves as expanded
    views (no copy), per-env leaves (from `model_gather`) as they are."""
    out = {}
    for f in dataclasses.fields(Model):
        v = getattr(m, f.name)
        if _batched(v, f.name):
            if v.shape[0] != B:
                raise ValueError(f"Model.{f.name}: leading dim "
                                 f"{v.shape[0]}, expected {B} envs (gather "
                                 "a library with model_gather first)")
            out[f.name] = v
        else:
            out[f.name] = v.expand((B,) + tuple(v.shape))
    return Model(**out)


def model_to_numpy(m: Model) -> dict:
    out = {}
    for f in dataclasses.fields(Model):
        v = getattr(m, f.name)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[f.name] = np.asarray(v, np.float32)
    return out
