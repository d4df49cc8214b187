"""The check chip_smoke.py holds the dynamic box's control step to (phase
objects (c): `gate` with witnesses), on sixteen envs of its own draw as the
card stepped them (tests/data/box_step_card.npz: the inputs and the card's
float32 answer, envs 96-111 of the phase's 256).

Env 102 (row 6 here) is an edge env where the card lands on neither plain
version. Its step is smooth for eight substeps; at the ninth, a humanoid
SC sphere's center sits about 2.6 μm outside a face of the box, where the
face normal q / sqrt(q² + 1e-12) (the JAX package's `_obj_sdf` too) is
far from unit length and changes by ~5e4 per metre of q. Float32 rounding
of the sphere's box-frame position (~1e-7 m) then moves the contact force
by ~0.5 N, and the step's answer slides along a continuum: the float64
steps from the state moved by 1-2 float32 ulps spread over many times the
bounds, the host's float32 step lands off the float64 one, and the card's
lands off both. `gate` fails it; with the host's moved steps as witnesses
one of them lands on the card's answer and `gate` passes."""
import numpy as np
import pytest
import torch

import chip_smoke as C

EDGE = 6            # env 102 of the phase's draw
DATA = "tests/data/box_step_card.npz"


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads while the module runs (the suite runs several
    test processes side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def box():
    """(step(ins, dtype) -> (qpos', qvel') with the box's dofs appended,
    the inputs, the card's answer, the plain (float32, float64) answers)."""
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.envs import humanoid_im as H
    from uhc_tpu_torch.physics import objects as O
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    topo, model_np = load_fixture_humanoid()
    m32 = model_from_numpy(model_np, "cpu")
    models = {torch.float32: m32, torch.float64: C.double_model(m32)}
    env = Config.uhc_implicit().env
    d = np.load(DATA)
    ins = [torch.tensor(d[k]) for k in ("qpos", "qvel", "action",
                                        "target_base", "obj_qpos",
                                        "obj_qvel")]
    card = [torch.tensor(d["card_qpos"]), torch.tensor(d["card_qvel"])]

    def step(xs, dtype):
        qp, qv, a, t, q, v = (x.to(dtype) for x in xs)
        with torch.no_grad():
            out = H.do_simulation(
                topo, models[dtype], env, qp, qv, a, t, 1.0,
                obj=(O.make_obj_model([C.OBJ_BOX], "cpu", dtype), q, v))
        return (torch.cat([out[0], out[2]], 1),
                torch.cat([out[1], out[3]], 1))

    plain = (step(ins, torch.float32), step(ins, torch.float64))
    return step, ins, card, plain, topo, models


def _moved(box):
    step, ins = box[0], box[1]
    return lambda e: [step(C.ulp_moved(ins, e, dt, moved=(0, 1, 4, 5)), dt)
                      for dt in (torch.float64, torch.float32)]


def _off(q, v, ref):
    return torch.maximum((q.double() - ref[0]).abs().amax(1) / C.QPOS_TOL,
                         (v.double() - ref[1]).abs().amax(1) / C.QVEL_TOL)


def test_card_lands_on_neither_side_of_env_102(box):
    """Env 102 alone is an edge env of the sixteen (the host's float32
    step off the float64 one), and the card is off both there; every
    other env has the card within the bounds of both."""
    _, _, card, (p32, p64), *_ = box
    edge = _off(*p32, p64) > 1
    assert torch.nonzero(edge)[:, 0].tolist() == [EDGE]
    off = torch.maximum(_off(*card, p32), _off(*card, p64))
    assert torch.nonzero(off > 1)[:, 0].tolist() == [EDGE]
    assert _off(*card, p32)[EDGE] > 1 and _off(*card, p64)[EDGE] > 1


def test_face_normal_steep_at_substep_9(box, monkeypatch):
    """Float64 steps of env 102 from its state moved by 1-2 float32 ulps,
    substep by substep: their spread grows less than twofold a substep
    through the eighth, more than tenfold at the ninth, and ends past ten
    times the bounds (env 103's grows less than twofold at every
    substep). Before the ninth substep a sphere center sits between 0 and
    10 μm outside a box face, where the normal's length is below 0.99, as
    the JAX package's `_obj_sdf` gives it."""
    import jax
    import jax.numpy as jnp

    from uhc_tpu.physics import objects as JO
    from uhc_tpu_torch.maths import quat_rotate, quat_to_mat
    from uhc_tpu_torch.physics import engine as E
    from uhc_tpu_torch.physics import objects as O
    from uhc_tpu_torch.physics.model import model_per_env

    step, ins, _, (_, p64), topo, models = box
    subs, orig = [], E.substep

    def recording(*a, **k):
        out = orig(*a, **k)
        subs.append((out[0], out[3][0]))
        return out

    def spread(env):
        """(the unmoved step's substeps, the moved steps' spread from
        them in qpos and the box's qpos after each substep, the moved
        steps' (qpos', qvel'))"""
        one = [x[env:env + 1] for x in ins]
        subs.clear()
        step(one, torch.float64)
        base = list(subs)
        subs.clear()
        out = step(C.ulp_moved(one, 0, torch.float64, moved=(0, 1, 4, 5)),
                   torch.float64)
        return base, [max((m[0] - b[0]).abs().max().item(),
                          (m[1] - b[1]).abs().max().item())
                      for b, m in zip(base, subs)], out

    monkeypatch.setattr(E, "substep", recording)
    base, grow, (q15, v15) = spread(EDGE)
    _, calm, _ = spread(EDGE + 1)
    monkeypatch.undo()
    ratio = [b / a for a, b in zip(grow, grow[1:])]
    assert max(ratio[:7]) < 2 and ratio[7] > 10
    assert max(b / a for a, b in zip(calm, calm[1:])) < 2
    assert _off(q15, v15, [t[EDGE:EDGE + 1] for t in p64]).max() > 10

    qpos8, oq8 = base[7]
    m = model_per_env(models[torch.float64], 1)
    kin = E.fk(topo, models[torch.float64], qpos8)
    wc = (kin["xpos"][:, :, None] + quat_rotate(
        kin["xquat"][:, :, None], m.sc_point)).reshape(1, -1, 3)
    om = O.make_obj_model([C.OBJ_BOX], "cpu", torch.float64)
    _, n = O._obj_sdf(om, oq8[..., :3], oq8[..., 3:7], wc[:, None])
    lp = torch.einsum("enij,ensi->ensj", quat_to_mat(oq8[..., 3:7]),
                      wc[:, None] - oq8[..., :3][:, :, None])
    gap = (lp.abs() - om.half_extents[:, None]).amax(-1)[0, 0]
    s = int(torch.where(gap > 0, gap, torch.inf).argmin())
    assert 0 < gap[s].item() < 1e-5
    assert n[0, 0, s].norm().item() < 0.99
    with jax.enable_x64(True):
        jn = JO._obj_sdf(JO.make_obj_model([C.OBJ_BOX], jnp.float64),
                         jnp.asarray(oq8[0, :, :3].numpy()),
                         jnp.asarray(oq8[0, :, 3:7].numpy()),
                         jnp.asarray(wc.numpy()))[1]
    assert np.abs(np.asarray(jn)[0, s] - n[0, 0, s].numpy()).max() < 1e-9


def test_card_step_passes_gate_by_witness(box):
    """`gate` fails the card's answer on env 102 (kernel vs float32);
    with the host's moved steps it passes, env 102 its one witnessed env,
    a moved step within half the bounds of the card's answer."""
    _, _, card, (p32, p64), *_ = box
    _, fails = C.gate("card box step", card, p32, p64)
    assert len(fails) == 1 and "kernel_vs_plain32" in fails[0]
    errs, fails = C.gate("card box step", card, p32, p64, _moved(box))
    assert not fails, fails
    [row] = errs["edge_witnessed"]
    assert row["env"] == EDGE and row["nearest_moved_step"] < 1
    assert row["moved_steps_within_bounds"] >= 1


@pytest.mark.parametrize("env,col", [(EDGE, 10), (EDGE + 1, 10)])
def test_gate_refuses_a_moved_answer(box, env, col):
    """The card's answer with one humanoid dof moved by three times the
    qpos bound: on env 102, off the line its moved steps spread along, no
    witness lands there; on the sharp env 103 no witness is asked for.
    `gate` fails either."""
    _, _, card, (p32, p64), *_ = box
    bad = [card[0].clone(), card[1]]
    bad[0][env, col] += 3 * C.QPOS_TOL
    _, fails = C.gate("moved answer", bad, p32, p64, _moved(box))
    assert fails
