"""K1: one 30 Hz control step of the humanoid as a hand-written CUDA kernel
(`csrc/control_step.cu`), replacing the TPU kernel
uhc_tpu/physics/pallas_lane.py:83 make_fused_do_simulation_lane.

`ControlStep(topo, cfg, model, pcg_iters)` bakes the model into two device
tables (floats and ints) and is called as
`step(qpos (B,nq), qvel (B,nv), actions (B,A), target_base (B,ndof),
rfc_rate) -> (qpos', qvel')`; the 24-body humanoid has nq=76, nv=75,
remove_toe's 22-body tree nq=70, nv=69. On CUDA tensors it launches the
kernel of the tree's build (or raises); on CPU tensors it runs
the plain PyTorch version `control_step_reference`, the eager chain of
physics/engine.py + solver.py with the same schedule: exact inverses at
substep 0, then warm-started PCG with (pd_iters, fd_iters) iterations.
On every tree of up to 32 bodies an env's matrices sit in the block's
shared memory, J6 and G stored by subtree as the int table lays them out
(`jacobian_tables`); a launch sizes its shared memory from their floats
(`jg_floats`).

K1e, the per-env variant (pallas_lane.py `per_env`): given a model library
(leaves with a leading (S,) dim where sequences differ, see
physics/model.py) the float table becomes (S, P_TOTAL), one packed model
per row, and the call takes `seq_idx` (B,) int32, contiguous, on the
inputs' device; env b simulates row seq_idx[b]. The range 0 <= seq_idx < S
is checked on the host before the launch. Its plain version gathers the
model (`env_models`) and runs the same chain.

K1d, the big trees (pallas_lane.py with pcg_vpu_sub=True): a tree of 33
to 52 bodies (48-body masterfoot, 52-body SMPL-H) runs the same kernels
built for its body count (`csrc/build.py`, -DNB), with A_pd, A_fd and the
Jacobians in a per-env workspace in device memory that the wrapper
allocates once for the largest batch it has seen, and the preconditioners
Xp, Xf in shared memory; the env runs it at PCG (2, 2). A model library
takes every tree of up to 32 bodies (`LIBRARY_MAX_BODIES`); on a big tree
it is not ported.

K1f, explicit RFC (`residual_force_mode` other than "implicit") and
per-joint meta-PD (`meta_pd_joint`) in pallas_lane.py (`VFX`, `MPJ`,
:127-146, :878-908, host prep :1217-1246): a config with either runs
`control_step_f_kernel`, K1's physics with two operands the wrapper
prepares from the actions as the JAX wrapper does, the (B, 9·nb)
body-frame wrench of `engine.prep_explicit_vf` and the (B, 2, nv) per-dof
kp / kd scales (ones on the root dofs). On every tree of up to 32 bodies
with a shared model or a library (per-joint meta-PD only), and on the big
trees with a shared model, where it takes K1d's workspace; explicit RFC over a model
library raises ValueError, as pallas_lane.py:143-146 does.

K1g, `refresh_at=k` (pallas_lane.py:104-111, :1151-1181): the exact
inverse pair is computed again at substep k from that substep's systems,
as at substep 0; every kernel of the wrapper takes it (the int table's
I_REFRESH), and the plain version is `solver.do_simulation(...,
refresh_at=k)`.

K2b, the bfloat16 preconditioner (pallas_substep.py:284
make_fused_do_simulation with precond_bf16=True, split=False):
`ControlStep(..., precond_bf16=True)` at a symmetric schedule runs
`control_step_bf16_kernel`, the same physics with the exact inverses
rounded to bfloat16 and every preconditioner product's vector too, on any
tree and over a model library; its plain version is
`solver.do_simulation(..., precond_bf16=True)`. It is refused at an
asymmetric schedule, with K1f's terms and with refresh_at, as the JAX
package's v2 kernel has no such mode. The split=True form is
`control_step_split.ControlStepSplit(..., precond_bf16=True)`.

`LAUNCHES` counts kernel launches (not plain-version calls) of this
wrapper and of K2's (`control_step_split`), keyed by (entry, bodies,
library): entry "step" (K1, K1e, K1d), "k1f" (K1f), either with
"_refresh" where K1g's refresh_at is set, "head" or "tail" (K2), each of
"step", "head" and "tail" with "_bf16" under K2b, the tree's body count,
and whether a model library was given.
`reset_launches` empties it.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from uhc_tpu_torch.physics import solver as S
from uhc_tpu_torch.physics.model import (MODEL_BASE_NDIM, Model, Topology,
                                         env_models, model_from_numpy,
                                         model_to_numpy)
from uhc_tpu_torch.smpl.constants import self_collision_pairs
from uhc_tpu_torch.utils.spans import count

KPTS, SC, MAXPAIR = 16, 3, 64
# the trees a model library runs on (K1e): every tree of up to 32 bodies,
# as the JAX lane kernel's per_env path takes them
LIBRARY_MAX_BODIES = 32
LIM_K, LIM_D, SC_K, SC_D = 500.0, 20.0, 3000.0, 50.0   # engine defaults

# Model leaves that may differ per sequence in a library the env routes
# to K1e: what a body shape (smpl/robot.py model_from_betas, the anatomical
# ranges) or domain randomization (contact scalars, masses) varies. The
# JAX package's per-env kernel takes exactly these
# (uhc_tpu/physics/pallas_lane.py:65 PE_MODEL_LEAVES).
PE_MODEL_LEAVES = ("body_pos", "body_ipos", "body_mass", "body_inertia",
                   "body_iquat", "jnt_range", "contact_point", "sc_point",
                   "sc_radius", "contact_stiffness", "contact_damping",
                   "friction")

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def library_size(m: dict):
    """Rows S of a model library given as numpy leaves, None for a shared
    model."""
    sizes = {np.shape(v)[0] for k, v in m.items()
             if np.ndim(v) > MODEL_BASE_NDIM[k]}
    if len(sizes) > 1:
        raise ValueError(f"model library leaves disagree on S: {sizes}")
    return sizes.pop() if sizes else None


def jacobian_tables(topo: Topology):
    """J6 and G stored by subtree (control_step.cu I_JROW, I_JCOL, I_JPAIR):
    body b's 6 rows hold the dofs of its ancestors, b included, in dof
    order (6 + 3·depth(b) columns), so a dof has one column in the rows of
    every body below it -> (row offsets (6·nb + 1,), the last the floats
    of each matrix; each dof's column (nv,); the (body, dof) pairs, dof
    above body, as b·nv + j by body then column)."""
    nb, nv = topo.nbody, topo.nv
    topo.subtree_end()                  # raises unless depth-first
    depth = np.zeros(nb, np.int64)
    chain = [[0]]                       # each body's ancestors, root first
    for b in range(1, nb):
        p = topo.parents[b]
        depth[b] = depth[p] + 1
        chain.append(chain[p] + [b])
    rows = np.repeat(6 + 3 * depth, 6)
    jrow = np.concatenate([[0], np.cumsum(rows)])
    dof = np.arange(nv)
    db = topo.dof_body()
    jcol = np.where(dof < 6, dof, 6 + 3 * (depth[db] - 1) + (dof - 6) % 3)
    pairs = [b * nv + j for b in range(nb) for a in chain[b]
             for j in (range(6) if a == 0 else range(3 * a + 3, 3 * a + 6))]
    return jrow, jcol, np.asarray(pairs, np.int64)


def max_jacobian_pairs(nb: int) -> int:
    """The (body, dof) pairs of a chain of `nb` bodies, the most a tree
    has: the length of the int table's I_JPAIR (control_step.cu JP_MAX)."""
    return 6 * nb + 3 * nb * (nb - 1) // 2


def pack_tables(topo: Topology, cfg, model, pcg_iters=(1, 2),
                refresh_at=None):
    """Model + topology + config -> (float32 params, int32 table) in the
    layout of control_step.cu (P_* / I_* enums) of the build for
    topo.nbody bodies; `refresh_at` fills I_REFRESH (-1 for None). A
    model library gives (S, P_TOTAL) params, one packed model per row."""
    if topo.joint_kind != "euler":
        raise ValueError(f"the control-step kernel is built for euler-joint "
                         f"trees, not {topo.joint_kind} joints")
    S.check_supported(cfg)
    if cfg.action_type == "torque":
        raise ValueError("torque control runs no control-step kernel, as "
                         "in the JAX package (fused_compatible)")
    m = model_to_numpy(model) if isinstance(model, Model) else model
    n_lib = library_size(m)
    if n_lib is not None:
        rows = [pack_tables(topo, cfg, {
            k: (v[s] if np.ndim(v) > MODEL_BASE_NDIM[k] else v)
            for k, v in m.items()}, pcg_iters, refresh_at)
            for s in range(n_lib)]
        return np.stack([p for p, _ in rows]), rows[0][1]
    cp = np.asarray(m["contact_point"], np.float32)
    cmask = np.asarray(m["contact_mask"], np.float32)
    if cp.shape[1] > KPTS or np.asarray(m["sc_point"]).shape[1] != SC:
        raise ValueError("contact / self-collision table sizes unsupported")
    NB = topo.nbody
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
    # control_step.cu's RFC_* and GAINS_* values
    rfc = (0 if not cfg.residual_force else 1 if not S.explicit_rfc(cfg)
           else {None: 2, "height": 3, "ground": 4}[S.vf_gate_mode(cfg)])
    gains = 1 if cfg.meta_pd else 2 if cfg.meta_pd_joint else 0
    jrow, jcol, jpair = jacobian_tables(topo)
    itab = np.concatenate([
        np.asarray(topo.parents), topo.subtree_end(),
        np.pad(levbody, (0, NB - len(levbody))),
        np.pad(levstart, (0, NB + 1 - len(levstart))),
        [len(levels), len(pairs)],
        np.pad(pairs.reshape(-1), (0, 2 * MAXPAIR - pairs.size)),
        jrow, jcol, [len(jpair)],
        np.pad(jpair, (0, max_jacobian_pairs(NB) - len(jpair))),
        [int(cfg.self_collision), rfc, cfg.action_v, gains, pd_iters,
         fd_iters, cfg.frame_skip, -1 if refresh_at is None else refresh_at],
    ]).astype(np.int32)
    return params, itab


def control_step_reference(topo: Topology, cfg, model: Model, qpos, qvel,
                           actions, target_base, rfc_rate=1.0,
                           pcg_iters=(1, 2), seq_idx=None, refresh_at=None,
                           precond_bf16: bool = False):
    """The plain PyTorch version of the kernel (same schedule, the same
    refresh substep, the same preconditioner rounding); a model library is
    gathered by `seq_idx` first (K1e)."""
    return S.do_simulation(topo, cfg, env_models(model, seq_idx), qpos,
                           qvel, actions, target_base, rfc_rate, pcg_iters,
                           refresh_at=refresh_at, precond_bf16=precond_bf16)


def uses_k1f(cfg) -> bool:
    """Whether a config runs K1f: explicit RFC or per-joint gains."""
    return S.explicit_rfc(cfg) or S.per_joint_gains(cfg)


def lane_only(cfg) -> bool:
    """Explicit RFC or per-joint meta-PD: terms only the lane kernel takes
    (uhc_tpu/envs/humanoid_im.py:853 fused_compatible); the JAX package's
    v2 head/tail kernel has slots for neither."""
    return S.explicit_rfc(cfg) or bool(cfg.meta_pd_joint)


def k1f_operands(topo: Topology, cfg, model: Model, actions):
    """K1f's prepared operands from the actions (pallas_lane.py:1217-1246):
    the (B, 9·nb) body-frame [cp|f|τ] wrench of explicit RFC (body-major,
    `engine.prep_explicit_vf`), and the (B, 2, nv) per-dof kp / kd scales
    of per-joint meta-PD (ones on the root dofs); None where the config
    has no such term."""
    B = actions.shape[0]
    ndof, vf_dim, _ = S.action_dims(topo, cfg)
    vfx = S.explicit_wrench(topo, cfg, model, actions, ndof, vf_dim)
    if vfx is not None:
        vfx = vfx.reshape(B, 9 * topo.nbody).contiguous()
    gains = None
    if S.per_joint_gains(cfg):
        kp, kd = S.gain_scales(cfg, actions, ndof, vf_dim)
        gains = actions.new_ones((B, 2, topo.nv))
        gains[:, 0, 6:] = kp[:, 0]
        gains[:, 1, 6:] = kd[:, 0]
    return vfx, gains


def kept_action_columns(topo: Topology, cfg) -> int:
    """The action columns a kernel keeps in shared memory: the PD targets,
    implicit RFC's 6, the per-substep meta-PD scales (K1f reads the
    explicit wrench and per-dof scales from its own operands)."""
    ndof, vf_dim, meta_dim = S.action_dims(topo, cfg)
    if not uses_k1f(cfg):
        return ndof + vf_dim + meta_dim
    return (ndof + (0 if S.explicit_rfc(cfg) else vf_dim)
            + (meta_dim if cfg.meta_pd else 0))


class ControlStep:
    """The kernel wrapper with the model baked in."""

    def __init__(self, topo: Topology, cfg, model: Model,
                 pcg_iters=(1, 2), refresh_at=None,
                 precond_bf16: bool = False):
        if refresh_at is not None and not 0 < refresh_at < cfg.frame_skip:
            raise ValueError(f"refresh_at={refresh_at}: a substep in [1, "
                             f"{cfg.frame_skip})")
        pd_iters, fd_iters = ((pcg_iters, pcg_iters)
                              if isinstance(pcg_iters, int) else pcg_iters)
        if precond_bf16 and (pd_iters != fd_iters or uses_k1f(cfg)
                             or refresh_at is not None):
            # JAX's v2 kernel (pallas_substep.py) is the only one with the
            # flag: one PCG count, implicit RFC, per-substep gains
            raise ValueError("precond_bf16 takes a symmetric PCG schedule "
                             "and neither explicit RFC, per-joint meta-PD "
                             "nor refresh_at")
        self.topo, self.cfg, self.pcg_iters = topo, cfg, pcg_iters
        self.refresh_at, self.precond_bf16 = refresh_at, precond_bf16
        self.params, self.itab = pack_tables(topo, cfg, model, pcg_iters,
                                             refresh_at)
        # the floats of each of J6, G by subtree: the shared memory of a
        # launch on a tree of up to 32 bodies grows with them
        self.jg_floats = int(jacobian_tables(topo)[0][-1])
        # rows of the model library (K1e), None for a shared model (K1)
        self.num_models = (self.params.shape[0] if self.params.ndim == 2
                           else None)
        if self.num_models is not None and \
                topo.nbody > LIBRARY_MAX_BODIES:
            raise NotImplementedError(f"a model library on a {topo.nbody}-"
                                      f"body tree is not ported")
        # K1f: explicit RFC or per-joint meta-PD
        self.k1f = uses_k1f(cfg)
        if self.num_models is not None and S.explicit_rfc(cfg):
            raise ValueError("explicit RFC with a model library: the hull "
                             "projection tables are per shape (the JAX lane "
                             "kernel refuses it too)")
        self.act_dim = sum(S.action_dims(topo, cfg))
        self._model_np = model_to_numpy(model)
        self._models = {}
        self._tables = {}
        self._workspace = None

    def model_on(self, device) -> Model:
        key = str(torch.device(device))
        if key not in self._models:
            self._models[key] = model_from_numpy(self._model_np, device)
        return self._models[key]

    def library(self):
        """The CUDA library of this tree's kernel build."""
        from uhc_tpu_torch.csrc import build

        return build.load_library(self.topo.nbody)

    def workspace(self, B: int, device):
        """The matrix workspace of a big tree (B × W_TOTAL float32 on
        `device`, kept for the largest batch seen), None up to 32 bodies."""
        from uhc_tpu_torch.csrc import build

        per_env = build.layout(self.library())["workspace"]
        if per_env == 0:
            return None
        w = self._workspace
        if w is None or w.device != torch.device(device) \
                or w.numel() < B * per_env:
            w = self._workspace = torch.empty(B * per_env,
                                              dtype=torch.float32,
                                              device=device)
        return w

    def ws_ptr(self, B: int, device) -> int:
        w = self.workspace(B, device)
        return 0 if w is None else w.data_ptr()

    def _device_tables(self, device):
        key = str(device)
        if key not in self._tables:
            from uhc_tpu_torch.csrc import build

            lay = build.layout(self.library())
            if (lay["params"], lay["itab"]) != (self.params.shape[-1],
                                                self.itab.size):
                raise RuntimeError(f"table layout mismatch: kernel {lay}, "
                                   f"packed {self.params.shape}, "
                                   f"{self.itab.size}")
            kept = kept_action_columns(self.topo, self.cfg)
            if kept > lay["maxact"]:
                raise ValueError(f"{kept} action columns; the kernel holds "
                                 f"at most {lay['maxact']}")
            self._tables[key] = (
                torch.as_tensor(self.params, device=device),
                torch.as_tensor(self.itab, device=device))
        return self._tables[key]

    def check_inputs(self, qpos, qvel, actions, target_base,
                     operands=None) -> int:
        """The inputs' shapes, dtype, device and layout; with `operands`,
        K1f's prepared (vfx, gains) too, each present exactly where the
        config has its term."""
        B, t = qpos.shape[0], self.topo
        shapes = {"qpos": (B, t.nq), "qvel": (B, t.nv),
                  "actions": (B, self.act_dim), "target_base": (B, t.ndof)}
        ins = [qpos, qvel, actions, target_base]
        for name, x, want, shape in zip(
                ("vfx", "gains"), operands or (),
                (S.explicit_rfc(self.cfg), S.per_joint_gains(self.cfg)),
                ((B, 9 * t.nbody), (B, 2, t.nv))):
            if (x is not None) != want:
                raise ValueError(f"{name}: {'missing' if want else 'given'}"
                                 f" for this config")
            if want:
                shapes[name] = shape
                ins.append(x)
        for name, t in zip(shapes, ins):
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

    def check_seq_idx(self, seq_idx, qpos) -> None:
        """A library needs seq_idx (B,) int32, contiguous, on qpos's
        device, every entry in [0, S); a shared model takes none."""
        if self.num_models is None:
            if seq_idx is not None:
                raise ValueError("seq_idx given for a shared model")
            return
        if seq_idx is None:
            raise ValueError("a model library needs seq_idx")
        if tuple(seq_idx.shape) != (qpos.shape[0],) \
                or seq_idx.dtype != torch.int32 \
                or seq_idx.device != qpos.device \
                or not seq_idx.is_contiguous():
            raise ValueError(f"seq_idx: {tuple(seq_idx.shape)} "
                             f"{seq_idx.dtype} on {seq_idx.device}, expected "
                             f"contiguous int32 ({qpos.shape[0]},) on "
                             f"{qpos.device}")
        if seq_idx.numel() and seq_idx.is_cuda and \
                torch.cuda.is_current_stream_capturing():
            # a CUDA graph's capture (envs/step_graph.py): the host cannot
            # read the range, so the card checks it at every replay
            torch._assert_async(((seq_idx >= 0)
                                 & (seq_idx < self.num_models)).all())
        elif seq_idx.numel():
            count("host_sync")
            lo, hi = (int(v) for v in torch.aminmax(seq_idx))
            if lo < 0 or hi >= self.num_models:
                raise ValueError(f"seq_idx spans [{lo}, {hi}], the library "
                                 f"has {self.num_models} models")

    def seq_ptr(self, seq_idx) -> int:
        """The kernel's seq_idx argument: a device pointer or null."""
        return 0 if seq_idx is None else seq_idx.data_ptr()

    def count_launch(self, entry: str = "step") -> None:
        LAUNCHES[entry, self.topo.nbody, self.num_models is not None] += 1

    def _launch_k1f(self, lib, P, I, qpos, qvel, actions, target_base,
                    qpos_out, qvel_out, rfc_rate, seq_idx, stream) -> int:
        vfx, gains = k1f_operands(self.topo, self.cfg,
                                  self.model_on(qpos.device), actions)
        B = self.check_inputs(qpos, qvel, actions, target_base,
                              (vfx, gains))
        return lib.uhc_control_step_f(
            P.data_ptr(), self.seq_ptr(seq_idx), I.data_ptr(),
            qpos.data_ptr(), qvel.data_ptr(), actions.data_ptr(),
            target_base.data_ptr(), qpos_out.data_ptr(), qvel_out.data_ptr(),
            self.ws_ptr(B, qpos.device),
            0 if vfx is None else vfx.data_ptr(),
            0 if gains is None else gains.data_ptr(), B, self.act_dim,
            float(rfc_rate), self.jg_floats, stream)

    def __call__(self, qpos, qvel, actions, target_base, rfc_rate=1.0,
                 seq_idx=None):
        self.check_seq_idx(seq_idx, qpos)
        if qpos.device.type == "cpu":
            return control_step_reference(
                self.topo, self.cfg, self.model_on("cpu"), qpos, qvel,
                actions, target_base, rfc_rate, self.pcg_iters, seq_idx,
                self.refresh_at, self.precond_bf16)
        if qpos.device.type != "cuda":
            raise ValueError(f"unsupported device {qpos.device}")
        B = self.check_inputs(qpos, qvel, actions, target_base)
        qpos_out, qvel_out = torch.empty_like(qpos), torch.empty_like(qvel)
        if B == 0:
            return qpos_out, qvel_out
        lib = self.library()
        P, I = self._device_tables(qpos.device)
        # the entry launches on the thread's current device: make it
        # qpos's (a rank on cuda:1 may have cuda:0 current)
        with torch.cuda.device(qpos.device):
            stream = torch.cuda.current_stream(qpos.device).cuda_stream
            if self.k1f:
                rc = self._launch_k1f(lib, P, I, qpos, qvel, actions,
                                      target_base, qpos_out, qvel_out,
                                      rfc_rate, seq_idx, stream)
            else:
                entry = ("uhc_control_step_bf16" if self.precond_bf16
                         else "uhc_control_step")
                rc = getattr(lib, entry)(
                    P.data_ptr(), self.seq_ptr(seq_idx), I.data_ptr(),
                    qpos.data_ptr(), qvel.data_ptr(), actions.data_ptr(),
                    target_base.data_ptr(), qpos_out.data_ptr(),
                    qvel_out.data_ptr(), self.ws_ptr(B, qpos.device), B,
                    self.act_dim, float(rfc_rate), self.jg_floats, stream)
        if rc != 0:
            raise RuntimeError(f"control_step kernel launch failed: CUDA "
                               f"error {rc}")
        self.count_launch(("k1f" if self.k1f else "step")
                          + ("" if self.refresh_at is None else "_refresh")
                          + ("_bf16" if self.precond_bf16 else ""))
        return qpos_out, qvel_out


def control_step_flops(topo: Topology, cfg, active, pcg_iters=(1, 2),
                       start: int = 0, refresh_at=None):
    """Floating-point operations (multiply-add = 2) the kernel's algorithm
    needs for one control step of a batch, from the data: `active` holds,
    per substep, the (B, nb) bool ground-contact sets (as recorded by
    `solver.do_simulation(..., trace=...)`), starting at substep `start`
    (1 counts K2's tail alone). Counts the subtree-limited M, J6ᵀ·wrench
    and CD sums (CD and K = W·J6 only over bodies in contact, K at each
    body's ancestor dofs), the
    Cholesky inverses of substep 0 (and of substep `refresh_at`, K1g) and
    the PCG matvecs; with explicit RFC (K1f) each body's wrench every
    substep: three quaternion rotations (30 each), the gate (6), the
    lever arm and its moment (18) and the add into the body's external
    wrench (6), whose J6 projection the J6ᵀ·wrench sums already count. Per-dof gains cost nothing beyond the
    per-substep ones."""
    pd_iters, fd_iters = ((pcg_iters, pcg_iters)
                          if isinstance(pcg_iters, int) else pcg_iters)
    NV = topo.nv
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
    # the dofs above each body: K = W·J6's columns
    above = np.diff(jacobian_tables(topo)[0])[::6]
    vfx = (topo.nbody * (3 * 30 + (6 if S.vf_gate_mode(cfg) else 0) + 18
                         + 6) if S.explicit_rfc(cfg) else 0.0)
    total = 0.0
    for s, act in enumerate(active):
        act = np.asarray(act, bool)
        B = act.shape[0]
        total += B * (m_flops + proj + pcg + vfx
                      + (inv if s + start in (0, refresh_at) else 0.0))
        total += (act * (2.0 * 6 * pairs_with + 2.0 * 36 * above)).sum()
    return total
