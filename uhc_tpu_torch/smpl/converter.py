"""Model-to-model state remapping (PyTorch twin of uhc_tpu.smpl.converter,
the reference's uhc/smpllib/smpl_mujoco.py:36 SMPLConverter).

Maps qpos / qvel between the canonical 24-body SMPL humanoid and a
widened tree (masterfoot's extra foot bodies, SMPL-H's fingers), and gives
the new tree's per-joint gain, torque-limit and diff-weight tables. The
name matching happens once at construction and becomes static index
arrays, so every remap is one gather over the last axis; a slot of the new
tree that the source lacks reads zero.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from uhc_tpu_torch.physics.model import Topology
from uhc_tpu_torch.smpl.constants import BODY_DIFF_WEIGHTS, BODY_PARAMS

# body_ws (smpl_mujoco.py:40) and [kp, kd, gear, torque_limit]
# (smpl_mujoco.py:67) of the canonical model: the port's constants
SMPL_BODY_WS: Dict[str, float] = BODY_DIFF_WEIGHTS
SMPL_BODY_PARAMS: Dict[str, List[float]] = BODY_PARAMS

# SMPL-H hand extensions (smpl_mujoco.py:93-200): 0.3 diff weight and
# [100, 10, 1, 100] gains per finger segment. The reference table spells
# the right pinky "R_pinky"; the keys keep that spelling.
_FINGERS = [f"{s}_{f}{i}" for s in ("L", "R")
            for f in ("Index", "Middle", "Pinky", "Ring", "Thumb")
            for i in (1, 2, 3)]


def _table_key(f: str) -> str:
    return f.replace("P", "p") if f.startswith("R_P") else f


SMPLH_BODY_WS = {**{k: v for k, v in SMPL_BODY_WS.items()
                    if k not in ("L_Hand", "R_Hand")},
                 **{_table_key(f): 0.3 for f in _FINGERS}}
SMPLH_BODY_PARAMS = {**{k: v for k, v in SMPL_BODY_PARAMS.items()
                        if k not in ("L_Hand", "R_Hand")},
                     **{_table_key(f): [100, 10, 1, 100] for f in _FINGERS}}


def _addr(topo: Topology, root_width: int) -> Dict[str, tuple]:
    """Body name -> [start, end) of its slots: the free root takes
    `root_width` (7 in qpos, 6 in qvel), every other body 3 hinges."""
    out = {topo.body_names[0]: (0, root_width)}
    for i in range(1, topo.nbody):
        s = root_width + (i - 1) * 3
        out[topo.body_names[i]] = (s, s + 3)
    return out


def _forward(addr_s, addr_n, n_new: int) -> np.ndarray:
    """For each slot of the new layout, its index in the source (-1:
    absent, reads zero)."""
    idx = np.full(n_new, -1, np.int64)
    for name, (a, b) in addr_n.items():
        if name in addr_s:
            s0 = addr_s[name][0]
            idx[a:b] = np.arange(s0, s0 + (b - a))
    return idx


def _backward(names, addr_n, root_width: int) -> np.ndarray:
    """New-layout indices in the canonical joint order; a canonical joint
    the new tree lacks maps to -1."""
    parts = [np.arange(*addr_n[names[0]]) if names[0] in addr_n
             else np.full(root_width, -1, np.int64)]
    parts += [np.arange(*addr_n[j]) if j in addr_n
              else np.full(3, -1, np.int64) for j in names[1:]]
    return np.concatenate(parts)


def _take(x, idx: np.ndarray) -> torch.Tensor:
    """Gather `idx` along the last axis, zero where idx < 0."""
    x = torch.as_tensor(x)
    i = torch.as_tensor(np.maximum(idx, 0), device=x.device)
    keep = torch.as_tensor(idx >= 0, device=x.device).to(x.dtype)
    return x[..., i] * keep


class SMPLConverter:
    """Remaps between `topo` (the 24-body layout) and `new_topo`; the gain
    and weight tables come from the SMPL or the SMPL-H body tables."""

    def __init__(self, topo: Topology, new_topo: Topology,
                 smpl_model: str = "smpl"):
        self.topo, self.new_topo = topo, new_topo
        if smpl_model == "smpl":
            self.body_ws, self.body_params = SMPL_BODY_WS, SMPL_BODY_PARAMS
        else:
            self.body_ws, self.body_params = SMPLH_BODY_WS, SMPLH_BODY_PARAMS
        sq, sv = _addr(topo, 7), _addr(topo, 6)
        nq_a, nv_a = _addr(new_topo, 7), _addr(new_topo, 6)
        self.smpl_joint_names = list(sq.keys())
        self.new_joint_names = list(nq_a.keys())
        self._qpos_fwd = _forward(sq, nq_a, new_topo.nq)
        self._qvel_fwd = _forward(sv, nv_a, new_topo.nv)
        self._qpos_bwd = _backward(self.smpl_joint_names, nq_a, 7)
        self._qvel_bwd = _backward(self.smpl_joint_names, nv_a, 6)

    # -- state remaps (batched over leading dims) -----------------------------
    def qpos_smpl_2_new(self, qpos):
        return _take(qpos, self._qpos_fwd)

    def qvel_smpl_2_new(self, qvel):
        return _take(qvel, self._qvel_fwd)

    def qpos_new_2_smpl(self, qpos):
        return _take(qpos, self._qpos_bwd)

    def qvel_new_2_smpl(self, qvel):
        return _take(qvel, self._qvel_bwd)

    # -- per-joint tables of the new model (smpl_mujoco.py:259-281) -----------
    def get_new_diff_weight(self) -> np.ndarray:
        return np.array([self.body_ws.get(n, 0.0)
                         for n in self.new_joint_names])

    def _table(self, col: int, default: float) -> np.ndarray:
        return np.concatenate(
            [[self.body_params[n][col]] * 3 if n in self.body_ws
             else [default] * 3 for n in self.new_joint_names[1:]])

    def get_new_jkp(self):
        return self._table(0, 50.0)

    def get_new_jkd(self):
        return self._table(1, 5.0)

    def get_new_a_scale(self):
        return self._table(2, 1.0)

    def get_new_torque_limit(self):
        return self._table(3, 200.0)
