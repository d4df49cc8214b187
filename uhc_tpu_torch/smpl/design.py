"""Design-space morphology parameters, the Transform2Act lineage (PyTorch
port's copy of uhc_tpu.smpl.design; reference
uhc/smpllib/smpl_robot.py:798-949 Body.get_params / set_params,
:1654-1707 Robot.get_params / set_params / get_gnn_edges).

A design is data: `DesignSpace.set_params` maps a normalized [-1, 1]
vector to a new `Model` of tensors, differentiable through autograd where
the JAX package uses jax.grad. `population` stacks the designs of a (P, n)
tensor into a model library with every leaf batched, as the JAX package
builds one with jax.vmap; such a library runs through the batched env step
on the plain chain (every leaf batched is more than the per-env kernel
gathers, `control_step.PE_MODEL_LEAVES`).

Parameters per body (in topology order), as the reference specs them:
optional offset components ("xyz" / "xz" / "xy"), an optional bone length,
an optional bone angle (atan2 of the offset's z / x, turned in the x-z
plane); an optional leading beta block. The mapping "clip" or "sin"
squashes raw parameters as Robot.map_params does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from uhc_tpu_torch.physics.model import Model, Topology

_OFFSET_COMPS = {"xyz": (0, 1, 2), "xz": (0, 2), "xy": (0, 1)}


def _norm(x, lb, ub):
    return (x - lb) / (ub - lb) * 2.0 - 1.0


def _denorm(x, lb, ub):
    return (x + 1.0) * 0.5 * (ub - lb) + lb


def _t(x, like=None):
    """A float32 tensor of `x` (on `like`'s device)."""
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x, dtype=torch.float32,
        device=None if like is None else like.device)


class DesignSpace:
    """A normalized morphology parameter space over a Model.

    spec keys (all optional):
      "offset":   {"type": "xyz"|"xz"|"xy", "lb": float|list, "ub": ...}
      "bone_len": {"lb": float, "ub": float}
      "bone_ang": {"lb": float, "ub": float}
      "beta":     {"lb": float, "ub": float, "n": 10}
    as cfg.robot_cfg["body_params"] gives them; `mapping` is
    Robot.param_mapping ("clip" | "sin" | "none").
    """

    def __init__(self, topo: Topology, spec: Dict[str, dict],
                 mapping: str = "clip", bodies: Optional[List[str]] = None):
        self.topo = topo
        self.spec = spec
        self.mapping = mapping
        names = list(topo.body_names)
        # the non-root bodies (the root has no parent offset)
        self.body_idx = [names.index(b) for b in (bodies or names[1:])]
        self._layout = []        # (kind, body index or None, width)
        if "beta" in spec:
            self._layout.append(("beta", None, int(spec["beta"].get("n", 10))))
        for b in self.body_idx:
            if "offset" in spec:
                comps = _OFFSET_COMPS[spec["offset"].get("type", "xyz")]
                self._layout.append(("offset", b, len(comps)))
            if "bone_len" in spec:
                self._layout.append(("bone_len", b, 1))
            if "bone_ang" in spec:
                self._layout.append(("bone_ang", b, 1))
        self.n_params = sum(w for _, _, w in self._layout)

    def param_names(self) -> List[str]:
        out = []
        for kind, b, w in self._layout:
            if kind == "beta":
                out += [f"beta_{i}" for i in range(w)]
            elif kind == "offset":
                comps = _OFFSET_COMPS[self.spec["offset"].get("type", "xyz")]
                out += [f"{self.topo.body_names[b]}_offset_{'xyz'[c]}"
                        for c in comps]
            else:
                out.append(f"{self.topo.body_names[b]}_{kind}")
        return out

    def map_params(self, params):
        if self.mapping == "clip":
            return torch.clamp(params, -1.0, 1.0)
        if self.mapping == "sin":
            return torch.sin(params * (0.5 * np.pi))
        return params

    def get_params(self, model: Model, beta=None) -> torch.Tensor:
        """Model -> normalized (n_params,) tensor (Robot.get_params)."""
        bp = _t(model.body_pos)
        out = []
        for kind, b, w in self._layout:
            if kind == "beta":
                s = self.spec["beta"]
                out.append(_norm(bp.new_zeros(w) if beta is None
                                 else _t(beta, bp)[:w], s["lb"], s["ub"]))
            elif kind == "offset":
                s = self.spec["offset"]
                comps = list(_OFFSET_COMPS[s.get("type", "xyz")])
                out.append(_norm(bp[b][comps], _t(s["lb"], bp),
                                 _t(s["ub"], bp)))
            elif kind == "bone_len":
                s = self.spec["bone_len"]
                out.append(_norm(torch.linalg.norm(bp[b])[None],
                                 s["lb"], s["ub"]))
            else:  # bone_ang
                s = self.spec["bone_ang"]
                ang = torch.atan2(bp[b][2], bp[b][0])
                out.append(_norm(ang[None], s["lb"], s["ub"]))
        return torch.cat(out)

    def set_params(self, model: Model, params) -> Model:
        """Normalized vector -> the changed Model of tensors
        (Robot.set_params and rebuild): bone offsets move, stretch or
        turn; each changed body's geometry (COM, contact and
        self-collision proxies) and mass scale with its length ratio s,
        the inertia with s² (isotropic, as enforce_length_size
        approximates it), the self-collision radii with √s."""
        bp = _t(model.body_pos)
        params = self.map_params(_t(params, bp))
        rows = list(bp.unbind(0))
        scale = [bp.new_ones(())] * self.topo.nbody
        i = 0
        for kind, b, w in self._layout:
            chunk = params[i:i + w]
            i += w
            if kind == "beta":
                continue  # the caller's shape pipeline reads it
            cur = rows[b]
            if kind == "offset":
                s = self.spec["offset"]
                comps = list(_OFFSET_COMPS[s.get("type", "xyz")])
                val = _denorm(chunk, _t(s["lb"], bp), _t(s["ub"], bp))
                parts = list(cur.unbind(0))
                for k, c in enumerate(comps):
                    parts[c] = val[k]
                cur = torch.stack(parts)
            elif kind == "bone_len":
                s = self.spec["bone_len"]
                length = _denorm(chunk[0], s["lb"], s["ub"])
                cur_len = torch.clamp(torch.linalg.norm(cur), min=1e-6)
                cur = cur * (length / cur_len)
            else:  # bone_ang: the offset turned in the x-z plane
                s = self.spec["bone_ang"]
                ang = _denorm(chunk[0], s["lb"], s["ub"])
                r = torch.sqrt(cur[0] ** 2 + cur[2] ** 2)
                cur = torch.stack([r * torch.cos(ang), cur[1],
                                   r * torch.sin(ang)])
            scale[b] = (torch.clamp(torch.linalg.norm(cur), min=1e-6)
                        / torch.clamp(torch.linalg.norm(bp[b]), min=1e-6))
            rows[b] = cur
        scale = torch.stack(scale)
        m = {f.name: _t(getattr(model, f.name), bp)
             for f in dataclasses.fields(Model)}
        m.update(body_pos=torch.stack(rows),
                 body_ipos=m["body_ipos"] * scale[:, None],
                 body_mass=m["body_mass"] * scale,
                 body_inertia=m["body_inertia"] * scale[:, None] ** 2,
                 contact_point=m["contact_point"] * scale[:, None, None],
                 sc_point=m["sc_point"] * scale[:, None, None],
                 sc_radius=m["sc_radius"] * torch.sqrt(scale))
        return Model(**m)

    def rebuild(self, model: Model, params) -> Model:
        """Alias of set_params (Robot.rebuild applies the stored
        parameters)."""
        return self.set_params(model, params)

    def population(self, model: Model, params) -> Model:
        """The designs of a (P, n_params) tensor as a model library with
        every leaf batched, (P, ...) each, as jax.vmap of set_params
        builds it."""
        designs = [self.set_params(model, p) for p in _t(params)]
        return Model(**{f.name: torch.stack([getattr(d, f.name)
                                             for d in designs])
                        for f in dataclasses.fields(Model)})


def gnn_edges(topo: Topology) -> np.ndarray:
    """(E, 2) parent edges in body order (Robot.get_gnn_edges)."""
    return np.asarray([[i, topo.parents[i]]
                       for i in range(1, topo.nbody)], np.int32)
