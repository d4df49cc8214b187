"""The control-step kernel's yardstick, frozen: the operations its
algorithm needs for one control step of a batch (`control_step_flops`,
from the recorded ground-contact sets), and the bytes a step must move
(`control_step_bytes`: the state in and out, the actions, the PD base and
the packed model tables, each once). Copied verbatim from the port's
`physics/control_step.py` at commit 6fd2048, with its imports pointed at
the reference's frozen modules, so that a later change to the program
cannot move its own roofline."""
from __future__ import annotations

import numpy as np

from benchmark.reference.frozen.physics import solver as S
from benchmark.reference.frozen.physics.model import (MODEL_BASE_NDIM, Model,
                                                      Topology,
                                                      model_to_numpy)
from benchmark.reference.frozen.smpl.constants import self_collision_pairs

KPTS, SC, MAXPAIR = 16, 3, 64
LIM_K, LIM_D, SC_K, SC_D = 500.0, 20.0, 3000.0, 50.0   # engine defaults


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


def control_step_bytes(topo, cfg, model, B: int, pcg_iters=(1, 2)) -> int:
    """Bytes one control step of B envs moves at the least: qpos and qvel
    read and written, the actions and the PD base read, the packed float
    and int tables read once (float32 and int32)."""
    params, itab = pack_tables(topo, cfg, model, pcg_iters)
    act = sum(S.action_dims(topo, cfg))
    return 4 * (B * (2 * topo.nq + 2 * topo.nv + act + topo.ndof)
                + params.size + itab.size)
