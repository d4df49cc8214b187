"""The reference's own world, worked out again from the inputs: the
stand-in humanoid's model (mass properties, contact and self-collision
points from its meshes), the tree of the configuration, the expert
library from the motion file, the reset pose and the diff weights."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.frozen.config.config import Config
from benchmark.reference.frozen.data.dataset import (build_expert_library,
                                                     load_motion_file,
                                                     neutral_from_library)
from benchmark.reference.frozen.physics.model import model_from_numpy
from benchmark.reference.frozen.smpl.constants import default_diff_weights
from benchmark.reference.frozen.smpl.fixture_humanoid import \
    load_fixture_humanoid


@dataclasses.dataclass
class World:
    cfg: Config
    topo: object
    model: object           # Model of `dtype` tensors on `device`
    lib: dict               # expert library, floats in `dtype`
    aux: dict               # neutral_qpos / _qvel, jpos_diffw, body_diffw
    pcg_iters: object       # (pd, fd) PCG iterations, or one count
    dtype: torch.dtype


def config_of(cell_config: dict) -> Config:
    """The configuration file's settings as the frozen Config."""
    return Config.from_dict(cell_config["cfg_id"], cell_config["config"])


def build(cell_config: dict, device, dtype=torch.float64,
          pcg_iters=None) -> World:
    """The world of one configuration file on `device` in `dtype`."""
    cfg = config_of(cell_config)
    topo, m = load_fixture_humanoid()
    if cfg.env.robot_model == "smplh":
        from benchmark.reference.frozen.smpl.smplh import (smplh_diff_weights,
                                                           smplh_model,
                                                           smplh_topology)

        m = smplh_model(topo, m)
        topo = smplh_topology()
        jpw, bdw = smplh_diff_weights()
    else:
        jpw, bdw = default_diff_weights()
    model = model_from_numpy(m, device, dtype)
    # the library's features come out of the frozen code in float32 (its
    # poses are float32 arrays), then widen
    lib, _ = build_expert_library(
        topo, model_from_numpy(m, device),
        load_motion_file(cell_config["motion_file"]))
    lib = {k: (v.to(dtype) if torch.is_floating_point(v) else v)
           for k, v in lib.items()}
    nq, nv = neutral_from_library(lib)
    aux = {"neutral_qpos": nq, "neutral_qvel": nv,
           "jpos_diffw": torch.as_tensor(np.asarray(jpw), dtype=dtype,
                                         device=device),
           "body_diffw": torch.as_tensor(np.asarray(bdw), dtype=dtype,
                                         device=device)}
    pcg = cell_config["pcg_iters"] if pcg_iters is None else pcg_iters
    pcg = tuple(pcg) if isinstance(pcg, (list, tuple)) else int(pcg)
    return World(cfg, topo, model, lib, aux, pcg, dtype)


def as_dtype(world: World, dtype) -> World:
    """The same world in another dtype (the control's lower precision)."""
    def cast(x):
        return x.to(dtype) if torch.is_tensor(x) and \
            torch.is_floating_point(x) else x
    model = type(world.model)(**{f.name: cast(getattr(world.model, f.name))
                                 for f in dataclasses.fields(world.model)})
    return dataclasses.replace(
        world, model=model, lib={k: cast(v) for k, v in world.lib.items()},
        aux={k: cast(v) for k, v in world.aux.items()}, dtype=dtype)
