"""K2: the head/tail control step as two hand-written CUDA kernels
(`csrc/control_step.cu` `control_step_head_kernel` /
`control_step_tail_kernel`), replacing the TPU kernel
uhc_tpu/physics/pallas_substep.py:284 make_fused_do_simulation with
split=True, the route the JAX package takes under UHC_TPU_LANE=0.

`ControlStepSplit(topo, cfg, model, pcg_iters=2)` runs the symmetric PCG
schedule (pcg_iters on both the PD and the FD solve). A call launches the
head (substep 0: state and the exact inverses Xp, Xf of A_pd, A_fd, written
to a (B, 2, nv, nv) float32 buffer) and then the tail (substeps 1..14,
warm-started from Xp, Xf) on the current stream. On CPU tensors it runs
the plain version: `solver.substeps` over substep 0, then over 1..14.
Its one-launch counterpart is K1 with the same schedule,
`ControlStep(..., pcg_iters=(p, p))`, which head + tail equal bit for bit.

Given a model library, head and tail take the (S, P_TOTAL) table and
`seq_idx` exactly as K1e does (`ControlStep`), since all three share
`control_step_env`: this is the port's route for a library under
UHC_TPU_LANE=0 (the JAX package sends that case to its XLA chain).

On a big tree (48-body masterfoot, 52-body SMPL-H) head and tail are the
kernels of that tree's build, over the same per-env device workspace as
K1d (`ControlStep`); Xp/Xf travel as (B, 2, nv, nv). This is the route of
a big tree under UHC_TPU_LANE=0 or UHC_TPU_LANE_BIG=0, as in the JAX
package.

On the 55-body SMPL-X tree head and tail are the kernels of its -DNB=55
build, over the same workspace: the only kernel route of a tree of more
than 52 bodies, which the env takes whatever UHC_TPU_LANE says, as the
JAX package does (uhc_tpu/envs/humanoid_im.py:878-882,953-957).

K2b, `precond_bf16=True` (pallas_substep.py precond_bf16 with
split=True): the head rounds Xp, Xf to bfloat16 as it computes them and
writes them as a (B, 2, nv, nv) torch.bfloat16 buffer, half of K2's round
trip; every preconditioner product rounds its vector to bfloat16 and sums
in float32. The tail refuses a float32 buffer with the flag and a
bfloat16 one without it. The plain versions take the same keyword.

Explicit RFC and per-joint meta-PD are refused (ValueError), as the JAX
package's v2 kernel has no slots for them; the env never routes them
here.

Launches count in `control_step.LAUNCHES` under the entries "head" and
"tail", "head_bf16" and "tail_bf16" under K2b.
"""
from __future__ import annotations

import torch

from uhc_tpu_torch.physics import solver as S
from uhc_tpu_torch.physics.control_step import ControlStep, lane_only
from uhc_tpu_torch.physics.model import env_models


def head_reference(topo, cfg, model, qpos, qvel, actions, target_base,
                   rfc_rate=1.0, pcg_iters=2, seq_idx=None,
                   precond_bf16=False):
    """Plain head: substep 0 -> (qpos, qvel, X (B, 2, nv, nv)), X in
    qpos's dtype, or torch.bfloat16 with `precond_bf16` (K2b)."""
    q, v, (xp, xf) = S.substeps(topo, cfg, env_models(model, seq_idx), qpos,
                                qvel, actions, target_base, rfc_rate,
                                pcg_iters, 0, 1, precond_bf16=precond_bf16)
    X = torch.stack([xp, xf], 1)
    return q, v, X.to(torch.bfloat16) if precond_bf16 else X


def tail_reference(topo, cfg, model, qpos, qvel, actions, target_base, X,
                   rfc_rate=1.0, pcg_iters=2, seq_idx=None,
                   precond_bf16=False):
    """Plain tail: substeps 1..frame_skip-1 from the head's state and X
    (read in qpos's dtype)."""
    X = X.to(qpos.dtype)
    return S.substeps(topo, cfg, env_models(model, seq_idx), qpos, qvel,
                      actions, target_base, rfc_rate, pcg_iters, 1,
                      cfg.frame_skip, inverses=(X[:, 0], X[:, 1]),
                      precond_bf16=precond_bf16)[:2]


class ControlStepSplit(ControlStep):
    """K2 with the model baked in (the tables and input checks of K1)."""

    def __init__(self, topo, cfg, model, pcg_iters: int = 2,
                 precond_bf16: bool = False):
        if not isinstance(pcg_iters, int):
            raise TypeError("K2 runs one PCG count on both solves")
        if lane_only(cfg):
            # the env routes them to K1f or the plain chain
            raise ValueError("the head/tail kernels take neither explicit "
                             "RFC nor per-joint meta-PD (K1f runs them on "
                             "the lane route)")
        super().__init__(topo, cfg, model, (pcg_iters, pcg_iters),
                         precond_bf16=precond_bf16)
        # the dtype of the Xp/Xf buffer between head and tail
        self.x_dtype = torch.bfloat16 if precond_bf16 else torch.float32

    def _launch(self, part, qpos, qvel, actions, target_base, X, rfc_rate,
                seq_idx):
        entry = f"{part}_bf16" if self.precond_bf16 else part
        P, I = self._device_tables(qpos.device)
        q_out, v_out = torch.empty_like(qpos), torch.empty_like(qvel)
        B = qpos.shape[0]
        ws = self.ws_ptr(B, qpos.device)
        # the entry launches on the thread's current device: make it qpos's
        with torch.cuda.device(qpos.device):
            stream = torch.cuda.current_stream(qpos.device).cuda_stream
            rc = getattr(self.library(), f"uhc_control_step_{entry}")(
                P.data_ptr(), self.seq_ptr(seq_idx), I.data_ptr(),
                qpos.data_ptr(), qvel.data_ptr(), actions.data_ptr(),
                target_base.data_ptr(), q_out.data_ptr(), v_out.data_ptr(),
                ws, X.data_ptr(), B, self.act_dim, float(rfc_rate),
                self.jg_floats, stream)
        if rc != 0:
            raise RuntimeError(f"{entry} kernel launch failed: CUDA error "
                               f"{rc}")
        self.count_launch(entry)
        return q_out, v_out

    def _check(self, qpos, qvel, actions, target_base) -> int:
        if qpos.device.type != "cuda":
            raise ValueError(f"unsupported device {qpos.device}")
        return self.check_inputs(qpos, qvel, actions, target_base)

    def head(self, qpos, qvel, actions, target_base, rfc_rate=1.0,
             seq_idx=None):
        """Substep 0 -> (qpos, qvel, X (B, 2, nv, nv) = [Xp, Xf]), X float32
        or, under precond_bf16, bfloat16."""
        self.check_seq_idx(seq_idx, qpos)
        if qpos.device.type == "cpu":
            return head_reference(self.topo, self.cfg, self.model_on("cpu"),
                                  qpos, qvel, actions, target_base,
                                  rfc_rate, self.pcg_iters[0], seq_idx,
                                  self.precond_bf16)
        B, nv = self._check(qpos, qvel, actions, target_base), self.topo.nv
        X = torch.empty((B, 2, nv, nv), dtype=self.x_dtype,
                        device=qpos.device)
        if B == 0:
            return torch.empty_like(qpos), torch.empty_like(qvel), X
        q, v = self._launch("head", qpos, qvel, actions, target_base, X,
                            rfc_rate, seq_idx)
        return q, v, X

    def tail(self, qpos, qvel, actions, target_base, X, rfc_rate=1.0,
             seq_idx=None):
        """Substeps 1.. from the head's state and X -> (qpos, qvel); X is
        the head's buffer, float32 or, under precond_bf16, bfloat16."""
        self.check_seq_idx(seq_idx, qpos)
        B, nv = qpos.shape[0], self.topo.nv
        if tuple(X.shape) != (B, 2, nv, nv) or X.dtype != self.x_dtype \
                or X.device != qpos.device or not X.is_contiguous():
            raise ValueError(f"X: {tuple(X.shape)} {X.dtype} on {X.device}, "
                             f"expected contiguous {self.x_dtype} ({B}, 2, "
                             f"{nv}, {nv}) on {qpos.device}")
        if qpos.device.type == "cpu":
            return tail_reference(self.topo, self.cfg, self.model_on("cpu"),
                                  qpos, qvel, actions, target_base, X,
                                  rfc_rate, self.pcg_iters[0], seq_idx,
                                  self.precond_bf16)
        self._check(qpos, qvel, actions, target_base)
        if B == 0:
            return torch.empty_like(qpos), torch.empty_like(qvel)
        return self._launch("tail", qpos, qvel, actions, target_base, X,
                            rfc_rate, seq_idx)

    def __call__(self, qpos, qvel, actions, target_base, rfc_rate=1.0,
                 seq_idx=None):
        q, v, X = self.head(qpos, qvel, actions, target_base, rfc_rate,
                            seq_idx)
        return self.tail(q, v, actions, target_base, X, rfc_rate, seq_idx)

