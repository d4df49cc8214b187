"""Shape-conditioned humanoid models (PyTorch twin of
uhc_tpu.smpl.robot).

A body shape is data: `model_from_betas` maps SMPL betas to a `Model` of
the same layout as the base model. Joint offsets are exact (shape
blendshapes + joint regressor); COM, mass, inertia, contact points and
self-collision spheres are the base body's, scaled per body by the ratio
of skinned vertex extents (mass ~ s³, inertia ~ s⁵). The exact hull mass
properties of `uhc_tpu.smpl.robot.model_from_betas_exact` are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uhc_tpu_torch.physics.model import (Model, Topology, model_from_numpy,
                                         model_to_numpy)
from uhc_tpu_torch.smpl.constants import SMPL_2_MUJOCO
from uhc_tpu_torch.smpl.lbs import (SMPLData, mujoco_offsets_from_betas,
                                    shaped_joints, shaped_vertices)


def body_vertex_scale(data: SMPLData, betas, assignment: np.ndarray,
                      nbody: int) -> torch.Tensor:
    """Per-body rms vertex distance to the body's joint, relative to the
    zero-beta shape -> (nb,) linear scale factors."""
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(np.asarray(assignment, np.int64)), nbody).float()
    counts = torch.clamp(onehot.sum(0), min=1.0)
    order = torch.as_tensor(SMPL_2_MUJOCO.astype(np.int64))

    def rms(b):
        verts = shaped_vertices(data, b)
        joints = shaped_joints(data, b)[order]
        d2 = ((verts[:, None] - joints[None]) ** 2).sum(-1)      # (V, nb)
        return torch.sqrt((d2 * onehot).sum(0) / counts)

    betas = torch.as_tensor(betas, dtype=torch.float32)
    return rms(betas) / torch.clamp(rms(torch.zeros_like(betas)), min=1e-6)


def model_from_betas(topo: Topology, base_model: Model, data: SMPLData,
                     betas, assignment: np.ndarray) -> Model:
    """The Model of shape `betas` (CPU tensors; base_model's layout)."""
    base = model_from_numpy(model_to_numpy(base_model), "cpu")
    off, _root = mujoco_offsets_from_betas(data, betas)
    s = body_vertex_scale(data, betas, assignment, topo.nbody)
    return dataclasses.replace(
        base,
        body_pos=off.to(base.body_pos.dtype),
        body_ipos=base.body_ipos * s[:, None],
        body_mass=base.body_mass * s ** 3,
        body_inertia=base.body_inertia * s[:, None] ** 5,
        contact_point=base.contact_point * s[:, None, None],
        sc_point=base.sc_point * s[:, None, None],
        sc_radius=base.sc_radius * s,
    )


SHAPE_LEAVES = ("body_pos", "body_ipos", "body_mass", "body_inertia",
                "contact_point", "sc_point", "sc_radius")


def batched_models(topo: Topology, base_model: Model, data: SMPLData,
                   betas_batch, assignment: np.ndarray) -> Model:
    """model_from_betas over (B, n_betas) -> Model with a leading (B,) dim
    on the shape-dependent leaves (the rest shared)."""
    ms = [model_from_betas(topo, base_model, data, b, assignment)
          for b in torch.as_tensor(betas_batch, dtype=torch.float32)]
    return dataclasses.replace(ms[0], **{
        k: torch.stack([getattr(m, k) for m in ms]) for k in SHAPE_LEAVES})


def rel_joint_ranges(topo: Topology, base_model: Model) -> torch.Tensor:
    """Anatomical knee / ankle / toe joint ranges for shaped robots
    (reference smpl_robot.py:1087-1110 rel_joint_lm): knees hinge one way,
    ankles ±π/2, toes ±π/4 (±π/2 flexion); dofs per joint are
    (z, y, x)."""
    jr = np.array(torch.as_tensor(base_model.jnt_range).detach().cpu()
                  .numpy(), np.float32)
    names = list(topo.body_names)
    table = {
        "Knee": [(-np.pi / 16, np.pi / 16), (-np.pi / 16, np.pi / 16),
                 (-np.pi / 16, np.pi)],
        "Ankle": [(-np.pi / 2, np.pi / 2)] * 3,
        "Toe": [(-np.pi / 4, np.pi / 4), (-np.pi / 4, np.pi / 4),
                (-np.pi / 2, np.pi / 2)],
    }
    for part, rows in table.items():
        for side in ("L", "R"):
            n = f"{side}_{part}"
            if n not in names:
                continue
            base = 3 * (names.index(n) - 1)
            for k in range(3):
                jr[base + k] = rows[k]
    return torch.as_tensor(jr)
