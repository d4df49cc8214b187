"""Batched SMPL FK and the camera-fitting losses
(uhc_tpu_torch.smpl.humanoid_batch) against the JAX package's: FK, the OP
merge, screen normalization, the projection state, the four losses and
their gradients (torch.autograd against jax.grad) at a random pose and at
the zero pose, and a 25-step gradient descent. Offsets: the stand-in
humanoid's and the seeded synthetic SMPL data's. Tolerances: positions
2e-6 m, pixels 1e-3 (of ~1000), losses 1e-5 relative, gradients 1e-4 of
their largest entry (float32 on both sides, summed in other orders), the
OP merge's means 2 ulps, the
descent's losses 1e-4 relative after 25 steps."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import close, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

SMPL2OP = np.array([24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4,
                    7, 25, 26, 27, 28])
K = np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1]], np.float32)
R = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
T_CAM = np.array([0.0, 1.0, 4.0], np.float32)


def _offsets(kind):
    if kind == "stand_in":
        from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

        return np.asarray(load_fixture_humanoid()[1].body_pos, np.float32)
    from uhc_tpu.smpl.lbs import mujoco_offsets_from_betas
    from uhc_tpu.smpl.lbs import synthetic_smpl_data

    data = synthetic_smpl_data()
    off, root = mujoco_offsets_from_betas(
        data, jnp.zeros(data.shapedirs.shape[-1]))
    return np.asarray(off.at[0].set(root))


def _fits(offsets):
    from uhc_tpu.smpl import humanoid_batch as JHB
    from uhc_tpu_torch.smpl import humanoid_batch as HB

    jfit = JHB.CameraFit(offsets=jnp.asarray(offsets), full_R=jnp.asarray(R),
                         full_t=jnp.asarray(T_CAM), K=jnp.asarray(K),
                         img_w=1920, img_h=1080, smpl2op_map=SMPL2OP)
    fit = HB.CameraFit(offsets=offsets, full_R=R, full_t=T_CAM, K=K,
                       img_w=1920, img_h=1080, smpl2op_map=SMPL2OP,
                       device="cpu")
    return jfit, fit


def _vec(rng, T, scale=0.3):
    v = rng.normal(scale=scale, size=(T, 75)).astype(np.float32)
    v[:, :3] = rng.normal(scale=0.1, size=(T, 3)) + [0.0, 0.0, 0.9]
    return v


@pytest.mark.parametrize("kind", ["stand_in", "synthetic"])
def test_fk_and_projection(kind):
    from uhc_tpu.smpl import humanoid_batch as JHB
    from uhc_tpu_torch.smpl import humanoid_batch as HB

    rng = np.random.default_rng(1)
    off = _offsets(kind)
    v = _vec(rng, 6)
    for count in (True, False):
        want = JHB.fk_batch(jnp.asarray(off), jnp.asarray(v[:, 3:]),
                            jnp.asarray(v[:, :3]), count)
        got = HB.fk_batch(torch.from_numpy(off), torch.from_numpy(v[:, 3:]),
                          torch.from_numpy(v[:, :3]), count)
        close(want["wbpos"], got["wbpos"], 2e-6)
        close(want["wbquat"], got["wbquat"], 2e-6)
    x = rng.uniform(0, 1900, (4, 19, 2)).astype(np.float32)
    # means of pixels up to 1900: 2 float32 ulps
    close(JHB.smpl_op_to_op(jnp.asarray(x)),
          HB.smpl_op_to_op(torch.from_numpy(x)), 1e-5, 2.5e-7)
    close(JHB.normalize_screen_coordinates(jnp.asarray(x), 1280, 720),
          HB.normalize_screen_coordinates(torch.from_numpy(x), 1280, 720),
          1e-6)
    jfit, fit = _fits(off)
    wb = np.array(want["wbpos"])
    jj, jc = jfit.proj2d(jnp.asarray(wb), return_cam_3d=True)
    tj, tc = fit.proj2d(torch.from_numpy(wb), return_cam_3d=True)
    assert tuple(tj.shape) == (6, 12, 2) and tuple(tc.shape) == (6, 14, 3)
    close(jj, tj, 1e-3)
    close(jc, tc, 2e-6)


def _loss_set(jfit, fit, jline, line):
    """(name, JAX loss of a numpy vec, port loss of a tensor)."""
    return [
        ("proj_2d_loss", jfit.proj_2d_loss, fit.proj_2d_loss),
        ("proj_2d_loss_l1", lambda v: jfit.proj_2d_loss(v, ord=1),
         lambda v: fit.proj_2d_loss(v, ord=1)),
        ("proj_2d_loss_pixels", lambda v: jfit.proj_2d_loss(
            v, normalize=False), lambda v: fit.proj_2d_loss(
            v, normalize=False)),
        ("proj_2d_body_loss", jfit.proj_2d_body_loss, fit.proj_2d_body_loss),
        ("proj_2d_body_loss_l1_norm", lambda v: jfit.proj_2d_body_loss(
            v, ord=1, normalize=True), lambda v: fit.proj_2d_body_loss(
            v, ord=1, normalize=True)),
        ("proj_2d_line_loss", jline.proj_2d_line_loss,
         line.proj_2d_line_loss),
    ]


@pytest.mark.parametrize("kind", ["stand_in", "synthetic"])
def test_losses_and_gradients(kind):
    from uhc_tpu_torch.smpl import humanoid_batch as HB

    rng = np.random.default_rng(2)
    T = 7
    off = _offsets(kind)
    jfit, fit = _fits(off)
    jline, line = _fits(off)
    gt = rng.uniform(300, 1500, (T, 12, 2)).astype(np.float32)
    inl = rng.random((T, 12, 2)) > 0.2
    jfit.update_tgt_joints(gt, inl)
    fit.update_tgt_joints(gt, inl)
    close(jfit.weighting, fit.weighting, 1e-7)
    close(jfit.gt_2d_norm, fit.gt_2d_norm, 1e-6)
    close(jfit.camera_rays, fit.camera_rays, 1e-6)
    gt14 = rng.uniform(300, 1500, (T, 14, 2)).astype(np.float32)
    jline.update_tgt_joints(gt14, np.ones_like(gt14, bool))
    line.update_tgt_joints(gt14, np.ones_like(gt14, bool))
    losses = [(name, jax.value_and_grad(jf), tf)
              for name, jf, tf in _loss_set(jfit, fit, jline, line)]
    for v in (_vec(rng, T), np.zeros((T, 75), np.float32)):
        v[:, 2] = np.maximum(v[:, 2], 0.5)
        for name, jf, tf in losses:
            jl, jg = jf(jnp.asarray(v))
            tl, tg = HB.loss_and_grad(tf, torch.from_numpy(v))
            assert bool(torch.isfinite(tg).all()), name
            close(jl, tl, 1e-5 * abs(float(jl)), 0.0)
            close(jg, tg, 1e-4 * float(np.abs(jg).max()))
    root = np.array([0.05, -0.02, 0.9, 0.1, -0.2, 0.3], np.float32)
    for r in (root, np.zeros(6, np.float32)):
        jl, jg = jax.value_and_grad(jfit.proj_2d_root_loss)(jnp.asarray(r))
        tl, tg = HB.loss_and_grad(fit.proj_2d_root_loss, torch.from_numpy(r))
        close(jl, tl, 1e-5 * abs(float(jl)))
        close(jg, tg, 1e-4 * float(np.abs(jg).max()))


def test_descent_trajectory():
    """25 plain steps from a perturbed pose toward targets projected from
    the true pose: the loss falls and follows JAX's step by step."""
    from uhc_tpu_torch.smpl import humanoid_batch as HB

    rng = np.random.default_rng(3)
    T = 5
    off = _offsets("stand_in")
    jfit, fit = _fits(off)
    true = _vec(rng, T, 0.2)
    gt = np.asarray(jfit.proj2d(jnp.asarray(np.asarray(
        HB.fk_batch(torch.from_numpy(off), torch.from_numpy(true[:, 3:]),
                    torch.from_numpy(true[:, :3]))["wbpos"]))))
    jfit.update_tgt_joints(gt, np.ones(gt.shape))
    fit.update_tgt_joints(gt, np.ones(gt.shape))
    x0 = true + rng.normal(scale=0.05, size=true.shape).astype(np.float32)
    lr = 8.0
    g_fn = jax.jit(jax.value_and_grad(jfit.proj_2d_loss))
    v, jl = jnp.asarray(x0), []
    for _ in range(25):
        loss, g = g_fn(v)
        jl.append(float(loss))
        v = v - lr * g
    losses, grads, x = HB.descend(fit.proj_2d_loss, torch.from_numpy(x0),
                                  lr, 25)
    close(jl, losses, 0.0, 1e-4)
    close(np.asarray(v), x, 1e-4)
    assert losses[-1] < 0.5 * losses[0]
    assert bool(torch.all(losses[1:] <= losses[:-1]))
