"""Stand-in 24-body SMPL humanoid, written as MJCF + binary STL at run time.

The reference neutral SMPL MJCF and its meshes are not in the repository,
so the port (and its parity tests) run on this stand-in: the same tree,
body order and dof layout as the reference humanoid (nq=76, nv=75, 69
actuated dofs), z-y-x hinge joints with anatomical ranges, and one closed
convex mesh per body sized from its bone. Bodies are written in global
coordinates of the SMPL rest pose (y up, +z forward; the root quaternion
of each motion frame maps them into the z-up world, as for the reference
MJCF), so the MJCF loader derives real mass properties (density 1000,
about 60 kg in total), hull contact points and self-collision radii from
the meshes.

The skeleton is a hand-written table of an upright adult: pelvis about
0.92 m above the soles, which matches the root heights of the clips in
`sample_data/gait_clips.pkl`.

Usage::

    topo, model = load_fixture_humanoid()        # numpy-field Model
    xml = write_fixture_humanoid("/some/dir")     # MJCF path for any loader
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from benchmark.reference.frozen.smpl.constants import MUJOCO_BODY_ORDER, MUJOCO_PARENTS
from benchmark.reference.frozen.smpl.mesh import write_stl

# rest-pose joint positions (m), SMPL body frame: +y up, +x the body's left
JOINTS = {
    "Pelvis": (-0.0018, -0.2233, 0.0282),
    "L_Hip": (0.0695, -0.3141, 0.0239),
    "L_Knee": (0.1022, -0.6895, 0.0168),
    "L_Ankle": (0.0885, -1.0874, -0.0267),
    "L_Toe": (0.1148, -1.1437, 0.0925),
    "R_Hip": (-0.0678, -0.3143, 0.0213),
    "R_Knee": (-0.1061, -0.6945, 0.0186),
    "R_Ankle": (-0.0919, -1.0949, -0.0273),
    "R_Toe": (-0.1174, -1.1430, 0.0961),
    "Torso": (-0.0043, -0.1144, 0.0015),
    "Spine": (0.0012, 0.0208, 0.0027),
    "Chest": (0.0026, 0.0737, 0.0280),
    "Neck": (-0.0002, 0.2876, -0.0148),
    "Head": (0.0051, 0.3539, 0.0365),
    "L_Thorax": (0.0781, 0.1959, -0.0090),
    "L_Shoulder": (0.1725, 0.2257, -0.0178),
    "L_Elbow": (0.4320, 0.2132, -0.0424),
    "L_Wrist": (0.6813, 0.2222, -0.0435),
    "L_Hand": (0.7660, 0.2148, -0.0589),
    "R_Thorax": (-0.0752, 0.1924, -0.0100),
    "R_Shoulder": (-0.1754, 0.2255, -0.0195),
    "R_Elbow": (-0.4289, 0.2118, -0.0434),
    "R_Wrist": (-0.6842, 0.2196, -0.0469),
    "R_Hand": (-0.7688, 0.2137, -0.0576),
}

# per-body segment radius (m) of the prism meshes
RADIUS = {
    "L_Hip": 0.08, "L_Knee": 0.055, "R_Hip": 0.08, "R_Knee": 0.055,
    "Torso": 0.12, "Spine": 0.125, "Chest": 0.135, "Neck": 0.05,
    "Head": 0.095, "L_Thorax": 0.05, "L_Shoulder": 0.048,
    "L_Elbow": 0.038, "L_Wrist": 0.035, "L_Hand": 0.025,
    "R_Thorax": 0.05, "R_Shoulder": 0.048, "R_Elbow": 0.038,
    "R_Wrist": 0.035, "R_Hand": 0.025,
}

# leaf segments end at joint + extension (m)
LEAF_EXTENSION = {
    "Head": (0.0, 0.20, 0.0),
    "L_Hand": (0.08, 0.0, 0.0),
    "R_Hand": (-0.08, 0.0, 0.0),
}

# joint ranges in degrees, per hinge [z, y, x]
RANGE_DEG = {
    "Hip": ((-60, 60), (-60, 60), (-120, 45)),
    "Knee": ((-15, 15), (-15, 15), (-10, 150)),
    "Ankle": ((-30, 30), (-30, 30), (-60, 40)),
    "Toe": ((-30, 30), (-30, 30), (-30, 30)),
    "Torso": ((-45, 45), (-45, 45), (-45, 45)),
    "Spine": ((-45, 45), (-45, 45), (-45, 45)),
    "Chest": ((-45, 45), (-45, 45), (-45, 45)),
    "Neck": ((-60, 60), (-60, 60), (-60, 60)),
    "Head": ((-60, 60), (-60, 60), (-60, 60)),
    "Thorax": ((-45, 45), (-45, 45), (-45, 45)),
    "Shoulder": ((-90, 90), (-90, 90), (-90, 90)),
    "Elbow": ((-30, 30), (-150, 150), (-90, 90)),
    "Wrist": ((-60, 60), (-60, 60), (-60, 60)),
    "Hand": ((-45, 45), (-45, 45), (-45, 45)),
}

SOLE_BELOW_ANKLE = 0.06     # sole plane, below the ankle joint (m)
FOOT_HALF_WIDTH = 0.045


def _orient(tris: np.ndarray) -> np.ndarray:
    """Flip the winding if the mesh's signed volume is negative."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    if np.einsum("ij,ij->i", v0, np.cross(v1, v2)).sum() < 0:
        tris = tris[:, ::-1]
    return tris


def _prism(p0, p1, rx, ry=None, u=None, n=8):
    """Closed n-gon prism from p0 to p1 (elliptic section rx × ry); the
    section is rotated by π/n so one face lies flat along -v."""
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    ry = rx if ry is None else ry
    a = p1 - p0
    a = a / np.linalg.norm(a)
    if u is None:
        ref = np.array([0.0, 0.0, 1.0]) if abs(a[2]) < 0.9 else \
            np.array([1.0, 0.0, 0.0])
        u = np.cross(ref, a)
    u = np.asarray(u, float)
    u = u - a * (u @ a)
    u = u / np.linalg.norm(u)
    v = np.cross(a, u)
    th = np.pi / n + 2 * np.pi * np.arange(n) / n
    ring = rx * np.cos(th)[:, None] * u + ry * np.sin(th)[:, None] * v
    r0, r1 = p0 + ring, p1 + ring
    tris = []
    for k in range(n):
        k2 = (k + 1) % n
        tris += [(r0[k], r0[k2], r1[k2]), (r0[k], r1[k2], r1[k])]
        tris += [(p0, r0[k2], r0[k]), (p1, r1[k], r1[k2])]
    return _orient(np.array(tris))


def _body_mesh(name: str) -> np.ndarray:
    j = np.array(JOINTS[name])
    side = name[:2] if name[:2] in ("L_", "R_") else ""
    if name == "Pelvis":
        hx = 0.5 * (JOINTS["L_Hip"][0] - JOINTS["R_Hip"][0]) + 0.05
        return _prism(j + [-hx, 0, 0], j + [hx, 0, 0], 0.11, 0.09,
                      u=(0, 1, 0))
    if name.endswith("Ankle"):
        toe = np.array(JOINTS[side + "Toe"])
        sole = j[1] - SOLE_BELOW_ANKLE
        ry = 0.045
        cy = sole + ry * np.cos(np.pi / 8)
        return _prism((j[0], cy, j[2] - 0.06), (j[0], cy, toe[2]),
                      FOOT_HALF_WIDTH, ry, u=(1, 0, 0))
    if name.endswith("Toe"):
        ankle = np.array(JOINTS[side + "Ankle"])
        sole = ankle[1] - SOLE_BELOW_ANKLE
        ry = 0.02
        cy = sole + ry * np.cos(np.pi / 8)
        return _prism((j[0], cy, j[2]), (j[0], cy, j[2] + 0.06),
                      FOOT_HALF_WIDTH, ry, u=(1, 0, 0))
    i = MUJOCO_BODY_ORDER.index(name)
    children = [c for c in range(len(MUJOCO_BODY_ORDER))
                if MUJOCO_PARENTS[c] == i]
    if name in LEAF_EXTENSION:
        end = j + np.array(LEAF_EXTENSION[name])
    else:
        end = np.array(JOINTS[MUJOCO_BODY_ORDER[children[0]]])
    # shorten both ends a little so neighbouring segments overlap less; the
    # section is slightly elliptic so the principal axes are well defined
    d = end - j
    return _prism(j + 0.05 * d, end - 0.05 * d, RADIUS[name],
                  0.85 * RADIUS[name])


def _joint_range(name: str):
    key = name[2:] if name[:2] in ("L_", "R_") else name
    return RANGE_DEG[key]


def write_fixture_humanoid(directory: str) -> str:
    """Write the stand-in MJCF and its STL meshes into `directory`;
    returns the MJCF path."""
    os.makedirs(directory, exist_ok=True)
    lines = ['<mujoco model="humanoid_smpl_standin">',
             '  <compiler coordinate="global" angle="degree" '
             'inertiafromgeom="true"/>',
             '  <asset>']
    for name in MUJOCO_BODY_ORDER:
        write_stl(os.path.join(directory, f"{name}.stl"), _body_mesh(name))
        lines.append(f'    <mesh name="{name}" file="{name}.stl"/>')
    lines.append('  </asset>')
    lines.append('  <worldbody>')

    def fmt(v):
        return " ".join(f"{x:.6f}" for x in v)

    def body(i, indent):
        name = MUJOCO_BODY_ORDER[i]
        pad = " " * indent
        out = [f'{pad}<body name="{name}" pos="{fmt(JOINTS[name])}">']
        if i == 0:
            out.append(f'{pad}  <freejoint name="root"/>')
        else:
            for (lo, hi), ax, axis in zip(_joint_range(name), "zyx",
                                          ("0 0 1", "0 1 0", "1 0 0")):
                out.append(
                    f'{pad}  <joint name="{name}_{ax}" type="hinge" '
                    f'pos="{fmt(JOINTS[name])}" axis="{axis}" '
                    f'range="{lo:.4f} {hi:.4f}"/>')
        out.append(f'{pad}  <geom type="mesh" mesh="{name}" '
                   'density="1000"/>')
        for c in range(len(MUJOCO_BODY_ORDER)):
            if MUJOCO_PARENTS[c] == i:
                out += body(c, indent + 2)
        out.append(f'{pad}</body>')
        return out

    lines += body(0, 4)
    lines += ['  </worldbody>', '</mujoco>']
    path = os.path.join(directory, "humanoid_smpl_standin.xml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def load_fixture_humanoid():
    """Write the stand-in into a temporary directory, load it with the
    port's MJCF loader and delete the files: returns (Topology, Model of
    numpy arrays).

    The stand-in's mass properties come from the float64 numpy path of
    `smpl.mesh` (`load_mjcf_humanoid(native=False)`). The native toolkit,
    the MJCF loader's default, sums vertex coordinates in float32, and the
    stand-in's meshes sit in global coordinates: there its COMs move by up
    to 5e-7 m and its small bodies' inertias by up to 6e-4 relative, and
    where a prism's principal moments are near-equal its principal frame
    (body_iquat) turns by up to a right angle. Every recorded number of
    the port (kernel digests, times, parity bounds) was taken on the
    numpy-built stand-in."""
    from benchmark.reference.frozen.smpl.mjcf import load_mjcf_humanoid

    with tempfile.TemporaryDirectory(prefix="uhc_standin_") as d:
        return load_mjcf_humanoid(write_fixture_humanoid(d), native=False)
