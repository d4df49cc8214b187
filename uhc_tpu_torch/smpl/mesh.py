"""Host-side mesh utilities (numpy/scipy twin of uhc_tpu.smpl.mesh).

* binary/ASCII STL reading,
* exact solid mass properties of a closed triangle mesh (divergence
  theorem), standing in for MuJoCo's inertiafromgeom at density 1000,
* contact points: farthest-point-sampled convex-hull vertices.

Runs once at model-build time.
"""
from __future__ import annotations

import numpy as np


def load_stl(path: str) -> np.ndarray:
    """Read an STL file -> (n_tri, 3, 3) float64 triangle vertices."""
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    if len(rest) >= 4:
        n = np.frombuffer(rest[:4], dtype="<u4")[0]
        if 4 + n * 50 == len(rest):
            rec = np.frombuffer(rest[4:4 + n * 50],
                                dtype=np.uint8).reshape(n, 50)
            data = rec[:, :48].copy().view("<f4").reshape(n, 4, 3)
            return data[:, 1:4].astype(np.float64)
    text = (head + rest).decode("ascii", errors="ignore")
    verts = [[float(t) for t in line.split()[1:4]]
             for line in (ln.strip() for ln in text.splitlines())
             if line.startswith("vertex")]
    return np.array(verts, dtype=np.float64).reshape(-1, 3, 3)


def write_stl(path: str, tris: np.ndarray) -> None:
    """Write (n_tri, 3, 3) triangles as binary STL (normals from winding)."""
    tris = np.asarray(tris, np.float32)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    rec = np.zeros(len(tris), dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)),
                                      ("attr", "<u2")])
    rec["n"] = n
    rec["v"] = tris
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(np.uint32(len(tris)).tobytes())
        f.write(rec.tobytes())


def mesh_mass_properties(tris: np.ndarray, density: float = 1000.0):
    """(mass, com (3,), inertia about the COM (3,3)) of a closed mesh."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    vol6 = np.einsum("ij,ij->i", v0, np.cross(v1, v2))
    volume = vol6.sum() / 6.0
    com = ((v0 + v1 + v2) / 4.0 * vol6[:, None]).sum(0) / (6.0 * volume)
    C = np.zeros((3, 3))
    for a in range(3):
        for b in range(3):
            s_ab = (v0[:, a] + v1[:, a] + v2[:, a]) * (
                v0[:, b] + v1[:, b] + v2[:, b])
            p_ab = v0[:, a] * v0[:, b] + v1[:, a] * v1[:, b] + \
                v2[:, a] * v2[:, b]
            C[a, b] = (vol6 * (s_ab + p_ab)).sum() / 120.0
    mass = density * volume
    C *= density
    C_com = C - mass * np.outer(com, com)
    inertia = np.trace(C_com) * np.eye(3) - C_com
    return mass, com, inertia


def principal_inertia(inertia: np.ndarray):
    """3x3 inertia -> (diag (3,), quat wxyz of the principal frame)."""
    from scipy.spatial.transform import Rotation as sRot

    w, V = np.linalg.eigh(inertia)
    if np.linalg.det(V) < 0:
        V[:, 0] = -V[:, 0]
    q = sRot.from_matrix(V).as_quat()  # xyzw
    return w, np.roll(q, 1)


def convex_hull_points(verts: np.ndarray, k: int) -> np.ndarray:
    """k well-spread convex-hull vertices (farthest-point sampling seeded at
    the lowest-z vertex)."""
    from scipy.spatial import ConvexHull

    uv = np.unique(np.round(verts, 6), axis=0)
    if len(uv) > 3:
        try:
            pts = uv[ConvexHull(uv).vertices]
        except Exception:
            pts = uv
    else:
        pts = uv
    if len(pts) <= k:
        return np.concatenate([pts, np.tile(pts[-1:], (k - len(pts), 1))])
    chosen = [int(np.argmin(pts[:, 2]))]
    d = np.linalg.norm(pts - pts[chosen[0]], axis=1)
    for _ in range(k - 1):
        nxt = int(np.argmax(d))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(pts - pts[nxt], axis=1))
    return pts[chosen]
