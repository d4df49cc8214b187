"""The port's native mesh toolkit (uhc_tpu_torch/native/meshtools.cpp,
built with g++ on first use) against the JAX package's native toolkit and
the port's own numpy path, on the stand-in humanoid's meshes and a seeded
closed mesh: STL triangles equal; mass properties equal to the JAX
library's bit for bit and near the numpy path (float32 sums, below);
ASCII STL through the numpy reader; farthest-point sampling; a failed
build raises."""
import os
import tempfile

import numpy as np
import pytest

from test_torch_helpers import close

# The native toolkit takes float32 triangles (the JAX binding rounds
# them) and sums each triangle's vertex coordinates in float32 before it
# accumulates in double, where the numpy path keeps float64 throughout.
# The mass (double products of the vertices) agrees to 1e-12. The COM and
# the inertia about it do not: the stand-in's meshes sit in global
# coordinates up to ~1.7 m from the origin, so a float32 sum is off by
# ~1e-7 m, and the inertia about the COM (the origin's second moment less
# m·com·comᵀ) cancels most of its digits on a 5 cm body. Measured on the
# stand-in: COM 5.2e-7 m, inertia 6.3e-4 of the body's largest entry
# (2.0e-7 kg m²).
MASS_RTOL, COM_ATOL, INERTIA_RTOL = 1e-12, 1e-6, 1e-3


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The stand-in's STL files and a seeded closed convex mesh."""
    from scipy.spatial import ConvexHull

    from uhc_tpu_torch.smpl.fixture_humanoid import write_fixture_humanoid
    from uhc_tpu_torch.smpl.mesh import write_stl

    d = tmp_path_factory.mktemp("standin")
    write_fixture_humanoid(str(d))
    files = sorted(str(d / f) for f in os.listdir(d) if f.endswith(".stl"))
    pts = np.random.default_rng(5).standard_normal((60, 3)) * [0.1, 0.2, 0.3]
    hull = ConvexHull(pts)
    tris = pts[hull.simplices]
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    flip = np.einsum("ij,ij->i", n, tris[:, 0] - pts.mean(0)) < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    path = str(d / "hull.stl")
    write_stl(path, tris)
    return files + [path]


def test_stl_reads_equal(meshes):
    """Every file: the port's native reader, the JAX package's native
    reader and the port's numpy reader give the same triangles."""
    import uhc_tpu.native.meshtools as jax_native
    from uhc_tpu_torch.native import meshtools
    from uhc_tpu_torch.smpl import mesh

    assert len(meshes) == 25
    for path in meshes:
        got = meshtools.load_stl(path)
        assert got.dtype == np.float64 and got.shape[1:] == (3, 3)
        np.testing.assert_array_equal(got, jax_native.load_stl(path))
        np.testing.assert_array_equal(got, mesh.load_stl(path, native=False))
        np.testing.assert_array_equal(got, mesh.load_stl(path))


def test_mass_properties(meshes):
    """Native mass, COM and inertia equal the JAX library's bit for bit
    (the same source and flags); against the numpy path the mass within
    MASS_RTOL, the COM within COM_ATOL and the inertia within INERTIA_RTOL
    of its largest entry (the float32 sums, above)."""
    import uhc_tpu.native.meshtools as jax_native
    from uhc_tpu_torch.native import meshtools
    from uhc_tpu_torch.smpl import mesh

    worst = [0.0, 0.0, 0.0]
    for path in meshes:
        tris = mesh.load_stl(path)
        got = meshtools.mass_properties(tris, 1000.0)
        assert mesh.mesh_mass_properties(tris)[0] == got[0]
        for a, b in zip(jax_native.mass_properties(tris, 1000.0), got):
            np.testing.assert_array_equal(a, b)
        m, com, inertia = mesh.mesh_mass_properties(tris, native=False)
        assert got[0] > 0
        worst = [max(worst[0], abs(got[0] - m) / m),
                 max(worst[1], float(np.abs(got[1] - com).max())),
                 max(worst[2], float(np.abs(got[2] - inertia).max()
                                     / np.abs(inertia).max()))]
    print(f"native vs numpy: mass {worst[0]:.2e} relative, COM "
          f"{worst[1]:.2e} m, inertia {worst[2]:.2e} relative")
    assert worst[0] <= MASS_RTOL and worst[2] <= INERTIA_RTOL
    assert worst[1] <= COM_ATOL


def test_ascii_stl_goes_to_numpy(tmp_path):
    """An ASCII STL counts -1 triangles natively; load_stl parses it with
    the numpy reader, as in the JAX package."""
    from uhc_tpu_torch.native import meshtools
    from uhc_tpu_torch.smpl import mesh

    tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[0, 0, 0], [0, 1, 0], [0, 0, 1]]], np.float64)
    lines = ["solid t"]
    for t in tris:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {x} {y} {z}" for x, y, z in t]
        lines += ["endloop", "endfacet"]
    path = tmp_path / "a.stl"
    path.write_text("\n".join(lines + ["endsolid t"]) + "\n")
    assert meshtools.stl_tri_count(path.read_bytes()) == -1
    assert meshtools.load_stl(str(path)) is None
    np.testing.assert_array_equal(mesh.load_stl(str(path)), tris)


def test_farthest_point_sample_matches_jax():
    import uhc_tpu.native.meshtools as jax_native
    from uhc_tpu_torch.native import meshtools

    pts = np.random.default_rng(6).standard_normal((200, 3))
    got = meshtools.farthest_point_sample(pts, 16)
    np.testing.assert_array_equal(got,
                                  jax_native.farthest_point_sample(pts, 16))
    assert len(set(got.tolist())) == 16
    assert got[0] == int(np.argmin(pts[:, 2]))


def test_stand_in_on_either_path():
    """The stand-in built on the native path against the numpy-built one
    (`load_fixture_humanoid`'s default): masses equal, COMs and the
    sphere chains that follow them within COM_ATOL, the principal moments
    within INERTIA_RTOL of each body's largest; body_iquat turns by up to
    a right angle where a prism's moments are near-equal, while the
    inertia tensor it spans (R diag Rᵀ) stays within INERTIA_RTOL of each
    body's largest entry; every other leaf equal."""
    import dataclasses

    from scipy.spatial.transform import Rotation

    from uhc_tpu_torch.smpl.fixture_humanoid import (load_fixture_humanoid,
                                                     write_fixture_humanoid)
    from uhc_tpu_torch.smpl.mjcf import load_mjcf_humanoid

    _, a = load_fixture_humanoid()
    with tempfile.TemporaryDirectory() as d:
        _, b = load_mjcf_humanoid(write_fixture_humanoid(d))

    def per_body(x, y, rtol):
        scale = np.abs(x).reshape(len(x), -1).max(1)
        err = np.abs(x - y).reshape(len(x), -1).max(1)
        assert np.all(err <= rtol * scale), (err / scale).max()

    for f in dataclasses.fields(a):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        if f.name == "body_inertia":
            per_body(x, y, INERTIA_RTOL)
        elif f.name in ("body_ipos", "sc_point", "sc_radius"):
            close(x, y, COM_ATOL)
        elif f.name != "body_iquat":
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    assert not np.array_equal(a.body_iquat, b.body_iquat)

    def tensor(m):
        R = Rotation.from_quat(np.roll(m.body_iquat, -1, axis=1)).as_matrix()
        return np.einsum("bij,bj,bkj->bik", R, m.body_inertia, R)

    per_body(tensor(a), tensor(b), INERTIA_RTOL)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compile that fails raises with the compiler's message; nothing
    falls back to numpy on its own."""
    from uhc_tpu_torch.native import meshtools

    monkeypatch.setattr(meshtools, "_lib", None)
    monkeypatch.setattr(meshtools, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(meshtools, "FLAGS",
                        meshtools.FLAGS + ["-DMESHTOOLS_NO_SUCH", "-include",
                                           "no_such_header.h"])
    with pytest.raises(RuntimeError, match="mesh toolkit build failed"):
        meshtools.load()
    assert os.listdir(tmp_path) == []
