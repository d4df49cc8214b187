"""K1: one 30 Hz control step of the 24-body humanoid as a hand-written CUDA
kernel (`csrc/control_step.cu`), replacing the TPU kernel
uhc_tpu/physics/pallas_lane.py:83 make_fused_do_simulation_lane.

`ControlStep(topo, cfg, model, pcg_iters)` bakes the model into two device
tables (floats and ints) and is called as
`step(qpos (B,76), qvel (B,75), actions (B,A), target_base (B,69), rfc_rate)
-> (qpos', qvel')`. On CUDA tensors it launches the kernel (or raises); on
CPU tensors it runs the plain PyTorch version `control_step_reference`, the
eager chain of physics/engine.py + solver.py with the same schedule: exact
inverses at substep 0, then warm-started PCG with (pd_iters, fd_iters)
iterations.

`LAUNCHES` counts kernel launches (not reference calls); `reset_launches`
sets it to 0.
"""
from __future__ import annotations


import numpy as np
import torch

from uhc_tpu_torch.physics import solver as S
from uhc_tpu_torch.physics.model import (Model, Topology, model_from_numpy,
                                         model_to_numpy)
from uhc_tpu_torch.smpl.constants import self_collision_pairs

NB, NV, NQ, NDOF, KPTS, SC, MAXPAIR, MAXACT = 24, 75, 76, 69, 16, 3, 64, 128
LIM_K, LIM_D, SC_K, SC_D = 500.0, 20.0, 3000.0, 50.0   # engine defaults

LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def pack_tables(topo: Topology, cfg, model, pcg_iters=(1, 2)):
    """Model + topology + config -> (float32 params, int32 table) in the
    layout of control_step.cu (P_* / I_* enums)."""
    if topo.nbody != NB or topo.joint_kind != "euler":
        raise ValueError("the control-step kernel is built for the 24-body "
                         "euler-joint humanoid")
    S.check_supported(cfg)
    m = model_to_numpy(model) if isinstance(model, Model) else model
    cp = np.asarray(m["contact_point"], np.float32)
    cmask = np.asarray(m["contact_mask"], np.float32)
    if cp.shape[1] > KPTS or np.asarray(m["sc_point"]).shape[1] != SC:
        raise ValueError("contact / self-collision table sizes unsupported")
    cp16 = np.zeros((NB, KPTS, 3), np.float32)
    cm16 = np.zeros((NB, KPTS), np.float32)
    cp16[:, :cp.shape[1]] = cp
    cm16[:, :cp.shape[1]] = cmask
    scal = [m["friction"], m["contact_stiffness"], m["contact_damping"],
            m["contact_depth_cap"], m["contact_vreg"],
            *np.asarray(m["gravity"]).reshape(3), m["dt"],
            cfg.residual_force_scale, cfg.residual_force_lim,
            *cfg.base_rot, SC_K, SC_D, LIM_K, LIM_D]
    params = np.concatenate([
        np.asarray(m[k], np.float32).reshape(-1) for k in (
            "body_pos", "body_ipos", "body_mass", "body_inertia",
            "body_iquat", "armature", "jkp", "jkd", "torque_lim",
            "jnt_range")] + [cp16.reshape(-1), cm16.reshape(-1),
                             np.asarray(m["sc_point"], np.float32).reshape(-1),
                             np.asarray(m["sc_radius"], np.float32),
                             np.asarray(scal, np.float32)])

    levels = topo.levels()
    levbody = np.concatenate([i for i, _ in levels])
    levstart = np.cumsum([0] + [len(i) for i, _ in levels])
    pairs = self_collision_pairs(topo)
    if len(pairs) > MAXPAIR:
        raise ValueError("too many self-collision pairs")
    pd_iters, fd_iters = ((pcg_iters, pcg_iters)
                          if isinstance(pcg_iters, int) else pcg_iters)
    itab = np.concatenate([
        np.asarray(topo.parents), topo.subtree_end(),
        np.pad(levbody, (0, NB - len(levbody))),
        np.pad(levstart, (0, NB + 1 - len(levstart))),
        [len(levels), len(pairs)],
        np.pad(pairs.reshape(-1), (0, 2 * MAXPAIR - pairs.size)),
        [int(cfg.self_collision), int(cfg.residual_force), cfg.action_v,
         int(cfg.meta_pd), pd_iters, fd_iters, cfg.frame_skip],
    ]).astype(np.int32)
    return params, itab


def control_step_reference(topo: Topology, cfg, model: Model, qpos, qvel,
                           actions, target_base, rfc_rate=1.0,
                           pcg_iters=(1, 2)):
    """The plain PyTorch version of the kernel (same schedule)."""
    return S.do_simulation(topo, cfg, model, qpos, qvel, actions,
                           target_base, rfc_rate, pcg_iters)


class ControlStep:
    """The kernel wrapper with the model baked in."""

    def __init__(self, topo: Topology, cfg, model: Model,
                 pcg_iters=(1, 2)):
        self.topo, self.cfg, self.pcg_iters = topo, cfg, pcg_iters
        self.params, self.itab = pack_tables(topo, cfg, model, pcg_iters)
        self.act_dim = sum(S.action_dims(topo, cfg))
        if self.act_dim > MAXACT:
            raise ValueError(f"{self.act_dim} action columns; the kernel "
                             f"holds at most {MAXACT}")
        self._model_np = model_to_numpy(model)
        self._models = {}
        self._tables = {}

    def model_on(self, device) -> Model:
        key = str(torch.device(device))
        if key not in self._models:
            self._models[key] = model_from_numpy(self._model_np, device)
        return self._models[key]

    def _device_tables(self, device):
        key = str(device)
        if key not in self._tables:
            from uhc_tpu_torch.csrc import build

            lay = build.layout(build.load_library())
            if (lay["params"], lay["itab"]) != (self.params.size,
                                                self.itab.size):
                raise RuntimeError(f"table layout mismatch: kernel {lay}, "
                                   f"packed {self.params.size}, "
                                   f"{self.itab.size}")
            self._tables[key] = (
                torch.as_tensor(self.params, device=device),
                torch.as_tensor(self.itab, device=device))
        return self._tables[key]

    def check_inputs(self, qpos, qvel, actions, target_base) -> int:
        B = qpos.shape[0]
        shapes = {"qpos": (B, NQ), "qvel": (B, NV),
                  "actions": (B, self.act_dim), "target_base": (B, NDOF)}
        for name, t in zip(shapes, (qpos, qvel, actions, target_base)):
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                 f"expected {shapes[name]}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
            if t.device != qpos.device:
                raise ValueError(f"{name} is on {t.device}, qpos on "
                                 f"{qpos.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} is not contiguous")
        return B

    def __call__(self, qpos, qvel, actions, target_base, rfc_rate=1.0):
        global LAUNCHES
        if qpos.device.type == "cpu":
            return control_step_reference(
                self.topo, self.cfg, self.model_on("cpu"), qpos, qvel,
                actions, target_base, rfc_rate, self.pcg_iters)
        if qpos.device.type != "cuda":
            raise ValueError(f"unsupported device {qpos.device}")
        B = self.check_inputs(qpos, qvel, actions, target_base)
        qpos_out, qvel_out = torch.empty_like(qpos), torch.empty_like(qvel)
        if B == 0:
            return qpos_out, qvel_out
        from uhc_tpu_torch.csrc import build

        lib = build.load_library()
        P, I = self._device_tables(qpos.device)
        stream = torch.cuda.current_stream(qpos.device).cuda_stream
        rc = lib.uhc_control_step(
            P.data_ptr(), I.data_ptr(), qpos.data_ptr(), qvel.data_ptr(),
            actions.data_ptr(), target_base.data_ptr(), qpos_out.data_ptr(),
            qvel_out.data_ptr(), B, self.act_dim, float(rfc_rate), stream)
        if rc != 0:
            raise RuntimeError(f"control_step kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES += 1
        return qpos_out, qvel_out


def control_step_flops(topo: Topology, cfg, active, pcg_iters=(1, 2),
                       start: int = 0):
    """Floating-point operations (multiply-add = 2) the kernel's algorithm
    needs for one control step of a batch, from the data: `active` holds,
    per substep, the (B, nb) bool ground-contact sets (as recorded by
    `solver.do_simulation(..., trace=...)`), starting at substep `start`
    (1 counts K2's tail alone). Counts the subtree-limited M, J6ᵀ·wrench
    and CD sums (CD and K = W·J6 only over bodies in contact), the
    substep-0 Cholesky inverses and the PCG matvecs."""
    pd_iters, fd_iters = ((pcg_iters, pcg_iters)
                          if isinstance(pcg_iters, int) else pcg_iters)
    end = topo.subtree_end()
    db = topo.dof_body()
    # per lower-triangle dof pair: the deepest shared body (or -1)
    deep = np.full((NV, NV), -1)
    for i in range(NV):
        for j in range(i + 1):
            bi, bj = db[i], db[j]
            if bi <= bj < end[bi]:
                deep[i, j] = bj
            elif bj <= bi < end[bj]:
                deep[i, j] = bi
    valid = deep >= 0
    span = np.where(valid, end[np.maximum(deep, 0)] - deep, 0)
    m_flops = 2.0 * 6 * span.sum()
    proj = 2.0 * 2 * 6 * sum(end[db[j]] - db[j] for j in range(NV))
    pcg = 2.0 * NV * NV * (3 + 2 * pd_iters) + 2.0 * NV * NV * (
        3 + 2 * fd_iters)
    inv = 2 * 2.0 * (NV ** 3 / 3 + NV ** 3 / 6 + NV ** 3 / 6)
    # pairs (i, j) whose shared subtree contains body b
    d0 = np.maximum(deep, 0)
    pairs_with = np.array([(valid & (d0 <= b) & (b < end[d0])).sum()
                           for b in range(topo.nbody)], np.float64)
    total = 0.0
    for s, act in enumerate(active):
        act = np.asarray(act, bool)
        B = act.shape[0]
        total += B * (m_flops + proj + pcg + (inv if s + start == 0
                                              else 0.0))
        total += (act * (2.0 * 6 * pairs_with + 2.0 * 36 * NV)).sum()
    return total
