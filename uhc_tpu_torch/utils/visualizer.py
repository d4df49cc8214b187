"""Headless trajectory visualizer (PyTorch twin of
uhc_tpu.utils.visualizer).

`render_comparison` draws simulated and expert skeletons side by side from
joint-position trajectories as matplotlib 3D stick figures (mp4, gif or
png frames, whichever the extension selects); `display_coverage` draws one
cell per evaluated clip; `render_eval_result` runs the env's own FK over
qpos trajectories (`fk_jpos`: every frame at once on the given device) and
renders. matplotlib is imported when a function draws; without it they
raise ImportError.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from uhc_tpu_torch.smpl.constants import MUJOCO_PARENTS


def _require_matplotlib(agg: bool = True):
    """matplotlib, on its file-only Agg backend unless `agg` is False (the
    interactive viewer picks its own)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "matplotlib is required to render (uhc_tpu_torch.utils."
            "visualizer, utils.interactive, cli/replay, cli/render_smpl_rig"
            "): render on a host that has it") from e
    if agg:
        matplotlib.use("Agg")
    return matplotlib


def _draw_skeleton(ax, jpos: np.ndarray, color: str, label: str = ""):
    parents = np.asarray(MUJOCO_PARENTS)
    for i in range(1, len(parents)):
        p = parents[i]
        ax.plot([jpos[p, 0], jpos[i, 0]], [jpos[p, 1], jpos[i, 1]],
                [jpos[p, 2], jpos[i, 2]], color=color, linewidth=2)
    ax.scatter(jpos[:, 0], jpos[:, 1], jpos[:, 2], color=color, s=8,
               label=label or None)


def render_frame(ax, pred_jpos: np.ndarray,
                 gt_jpos: Optional[np.ndarray] = None,
                 offset: float = 1.0, vf: Optional[np.ndarray] = None,
                 vf_scale: float = 0.005):
    """One frame: simulated skeleton (blue) + expert shifted by `offset`
    along +y (green). `vf` draws residual-force arrows: a 6-dim implicit
    root wrench (an arrow at the root, linear part) or (nb, 3+) per-body
    explicit forces."""
    ax.clear()
    _draw_skeleton(ax, pred_jpos, "tab:blue", "sim")
    if gt_jpos is not None:
        g = np.array(gt_jpos, copy=True)
        g[:, 1] += offset
        _draw_skeleton(ax, g, "tab:green", "expert")
    if vf is not None:
        vf = np.asarray(vf)
        if vf.ndim == 1:                       # implicit: root wrench
            origins = pred_jpos[0:1]
            forces = vf[None, 0:3]
        else:                                   # explicit: per-body forces
            origins = pred_jpos[: len(vf)]
            forces = vf[:, :3]
        mag = np.linalg.norm(forces, axis=1)
        keep = mag > 1e-6
        if np.any(keep):
            o, f = origins[keep], forces[keep] * vf_scale
            ax.quiver(o[:, 0], o[:, 1], o[:, 2], f[:, 0], f[:, 1], f[:, 2],
                      color="deepskyblue", linewidth=2)
    center = pred_jpos[0]
    ax.set_xlim(center[0] - 1.2, center[0] + 1.2)
    ax.set_ylim(center[1] - 1.2, center[1] + 1.2 + offset)
    ax.set_zlim(0, 2.0)
    ax.set_box_aspect((1, 1 + offset / 2.4, 0.8))


def render_comparison(pred_jpos_seq: np.ndarray,
                      gt_jpos_seq: Optional[np.ndarray] = None,
                      out_path: str = "out.mp4", fps: int = 30,
                      stride: int = 1,
                      vf_seq: Optional[np.ndarray] = None) -> str:
    """Render a (T, nb, 3) joint-position trajectory (optionally vs the
    expert) to mp4 / gif / png frames by the extension; an mp4 without
    ffmpeg on the host becomes a gif. Returns the path written (for png,
    the frames' pattern)."""
    _require_matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib import animation

    pred = np.asarray(pred_jpos_seq).reshape(len(pred_jpos_seq), -1, 3)
    gt = (np.asarray(gt_jpos_seq).reshape(len(gt_jpos_seq), -1, 3)
          if gt_jpos_seq is not None else None)
    frames = range(0, len(pred), stride)

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")

    vfs = np.asarray(vf_seq) if vf_seq is not None else None

    if out_path.endswith(".png"):
        base, _ = os.path.splitext(out_path)
        for t in frames:
            render_frame(ax, pred[t], None if gt is None else gt[t],
                         vf=None if vfs is None else vfs[t])
            fig.savefig(f"{base}_{t:04d}.png", dpi=80)
        plt.close(fig)
        return f"{base}_*.png"

    def update(t):
        render_frame(ax, pred[t], None if gt is None else gt[t],
                     vf=None if vfs is None else vfs[t])
        return []

    anim = animation.FuncAnimation(fig, update, frames=list(frames),
                                   interval=1000 / fps, blit=False)
    writer = ("pillow" if out_path.endswith(".gif") else "ffmpeg")
    try:
        anim.save(out_path, writer=writer, fps=max(fps // stride, 1))
    except (RuntimeError, ValueError):
        # no ffmpeg on the host: a gif instead
        out_path = os.path.splitext(out_path)[0] + ".gif"
        anim.save(out_path, writer="pillow", fps=max(fps // stride, 1))
    plt.close(fig)
    return out_path


def display_coverage(results: dict, out_path: str = "coverage.png",
                     metric: str = "mpjpe") -> str:
    """Per-clip coverage grid: one cell per evaluated clip, green = succ,
    red = fail, annotated with `metric`. `results` = {key: {"succ":
    bool/float, metric: float}} (the eval CLI's per-sequence dict)."""
    import math

    _require_matplotlib()
    import matplotlib.pyplot as plt

    keys = sorted(results)
    n = len(keys)
    cols = max(1, int(math.ceil(math.sqrt(n))))
    rows = int(math.ceil(n / cols))
    fig, axes = plt.subplots(rows, cols,
                             figsize=(2.6 * cols, 1.3 * rows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        m = results[k]
        ok = bool(m.get("succ", 0))
        ax.set_facecolor("#d3f2d3" if ok else "#f6c9c9")
        val = m.get(metric)
        txt = k if len(k) <= 24 else k[:21] + "..."
        ax.text(0.5, 0.62, txt, ha="center", va="center", fontsize=7,
                transform=ax.transAxes)
        if val is not None:
            ax.text(0.5, 0.25, f"{metric}={val:.1f}", ha="center",
                    va="center", fontsize=7, transform=ax.transAxes)
        ax.set_xticks([])
        ax.set_yticks([])
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    succ = sum(bool(results[k].get("succ", 0)) for k in keys)
    fig.suptitle(f"coverage {succ}/{n}", fontsize=10)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def fk_jpos(topo, model, qpos_seq, device) -> np.ndarray:
    """(T, nq) qpos -> (T, nb, 3) body positions by the env's FK, every
    frame in one batch on `device`. `model` is a numpy-field Model (the
    loaders') or one already on `device`."""
    import torch

    from uhc_tpu_torch.physics import engine as E
    from uhc_tpu_torch.physics.model import model_from_numpy

    dev = torch.device(device)
    if not isinstance(model.body_pos, torch.Tensor):
        model = model_from_numpy(model, dev)
    q = torch.as_tensor(np.asarray(qpos_seq, np.float32) if not isinstance(
        qpos_seq, torch.Tensor) else qpos_seq, dtype=torch.float32,
        device=dev)
    with torch.no_grad():
        return E.fk(topo, model, q)["xpos"].cpu().numpy()


def render_eval_result(topo, model, pred_qpos_seq, gt_qpos_seq=None,
                       out_path: str = "out.gif", *, device, **kw) -> str:
    """FK the qpos trajectories with the env's own kinematics on `device`
    and render them."""
    pred_j = fk_jpos(topo, model, pred_qpos_seq, device)
    gt_j = (fk_jpos(topo, model, gt_qpos_seq, device)
            if gt_qpos_seq is not None else None)
    return render_comparison(pred_j, gt_j, out_path, **kw)
