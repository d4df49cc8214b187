"""The robot variants (smpl/local_robot.py: upright_start, big_ankle,
box_feet, capsule, remove_toe) in both packages, on the stand-in loaded by
each package's own MJCF loader from one written file: every array equal
to 1e-6 and the topology equal."""
import dataclasses

import numpy as np
import pytest

from test_torch_helpers import few_threads, load_both

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

TRANSFORMS = ("upright_start", "big_ankle", "box_feet", "capsule",
              "remove_toe")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return load_both(tmp_path_factory.mktemp("standin"))


def _apply(L, name, topo, model):
    """(topo, model) after the transform `name` of module L."""
    if name == "upright_start":
        return topo, L.upright_start_model(model)
    if name == "remove_toe":
        return L.remove_toe_model(topo, model)
    return topo, getattr(L, f"{name}_model")(topo, model)


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_jax(both, name):
    import uhc_tpu.smpl.local_robot as JL
    import uhc_tpu_torch.smpl.local_robot as TL
    from uhc_tpu_torch.physics.model import Model

    (jt, jm), (tt, tm) = both
    jt2, jm2 = _apply(JL, name, jt, jm)
    tt2, tm2 = _apply(TL, name, tt, tm)
    assert (tt2.nbody, tt2.parents, tt2.body_names, tt2.joint_kind) == (
        jt2.nbody, jt2.parents, jt2.body_names, jt2.joint_kind)
    for f in dataclasses.fields(Model):
        a = np.asarray(getattr(tm2, f.name))
        b = np.asarray(getattr(jm2, f.name))
        assert a.shape == b.shape, f.name
        assert a.dtype == np.float32, f.name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f.name)


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_of_tensors_equals_numpy(both, name):
    """A model of tensors gives the numpy model's arrays."""
    import uhc_tpu_torch.smpl.local_robot as TL
    from uhc_tpu_torch.physics.model import Model, model_from_numpy

    _, (tt, tm) = both
    _, a = _apply(TL, name, tt, tm)
    _, b = _apply(TL, name, tt, model_from_numpy(tm, "cpu"))
    for f in dataclasses.fields(Model):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)),
                                      err_msg=f.name)


def test_remove_toe_folds_the_toes(both):
    """22 bodies, no toe; each ankle carries its toe's mass and the
    center of mass of both; the ankles' contact points are kept; the
    joint tables drop the toes' 6 dofs."""
    from uhc_tpu_torch.smpl.local_robot import remove_toe_model

    _, (tt, tm) = both
    t2, m2 = remove_toe_model(tt, tm)
    assert t2.nbody == 22 and "L_Toe" not in t2.body_names
    names = list(tt.body_names)
    for side in ("L", "R"):
        ia, it = names.index(f"{side}_Ankle"), names.index(f"{side}_Toe")
        ia2 = t2.body_names.index(f"{side}_Ankle")
        ma, mt = float(tm.body_mass[ia]), float(tm.body_mass[it])
        assert float(m2.body_mass[ia2]) == pytest.approx(ma + mt, rel=1e-6)
        com = (ma * tm.body_ipos[ia] + mt * (tm.body_pos[it]
                                             + tm.body_ipos[it])) / (ma + mt)
        np.testing.assert_allclose(m2.body_ipos[ia2], com, atol=1e-6)
        assert m2.contact_mask[ia2].sum() >= tm.contact_mask[ia].sum()
    assert m2.jkp.shape == (63,) and m2.armature.shape == (69,)
    assert m2.jnt_range.shape == (63, 2)
    t2.subtree_end()                      # depth-first: raises otherwise
