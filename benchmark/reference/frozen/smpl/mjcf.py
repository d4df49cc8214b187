"""MJCF import (twin of uhc_tpu.smpl.mjcf): `Topology` + `Model` arrays.

The reference generates its humanoids as MJCF XML
(uhc/khrylib/mocap/skeleton_mesh.py write_str) in **global** coordinates
(compiler coordinate="global") and lets MuJoCo derive local offsets and
mesh inertia. Here we parse that XML subset directly into engine arrays:

* body tree + local offsets (global positions differenced against parent),
* solid mass properties from the referenced STL meshes at density 1000
  (matching inertiafromgeom="true"),
* per-dof armature (0.01 hinge default from the template), joint ranges,
* contact candidate points from the mesh convex hulls.

It also reads back what `benchmark.reference.frozen.smpl.mjcf_export.export_mjcf`
writes: local coordinates (coordinate="local": a body's pos is its offset
from the parent), explicit <inertial> mass properties, the joints'
armature attribute, contact spheres as contact candidates and the
self-collision spheres (contype="0") as the sphere chains. A body without
those keeps the mesh-derived values.

Returns a Model whose fields are numpy arrays;
`benchmark.reference.frozen.physics.model.model_from_numpy` moves it to a device.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from benchmark.reference.frozen.physics.model import Model, Topology
from benchmark.reference.frozen.smpl import mesh as meshlib


def _parse_vec(s, n=3):
    return np.array([float(t) for t in s.split()][:n])


def load_mjcf_humanoid(
    path: str,
    density: float = 1000.0,
    contact_points_per_body: int = 8,
    foot_contact_points: int = 16,
    contact_stiffness: float = 30000.0,
    contact_damping: float = 600.0,
    contact_depth_cap: float = 0.01,
    contact_vreg: float = 0.01,
    friction: float = 1.0,
    armature_hinge: float = 0.01,
    native: bool = True,
):
    """Parse an MJCF humanoid (global-coordinate, mesh-geom subset used by the
    reference assets) into (Topology, Model as numpy dict), its meshes on
    the native toolkit of `smpl.mesh`, or on its numpy path (`native`
    False)."""
    tree = ET.parse(path)
    root = tree.getroot()
    compiler = root.find("compiler")
    is_global = compiler is not None and compiler.get("coordinate", "local") == "global"
    angle_deg = compiler is None or compiler.get("angle", "degree") == "degree"
    base = os.path.dirname(os.path.abspath(path))

    # asset meshes
    mesh_files = {}
    asset = root.find("asset")
    if asset is not None:
        for m in asset.findall("mesh"):
            f = m.get("file")
            name = m.get("name") or os.path.splitext(os.path.basename(f))[0]
            mesh_files[name] = os.path.normpath(os.path.join(base, f))

    names, parents, gpos, jranges, mesh_of = [], [], [], [], []
    # explicit values of an exported file, per body (None where absent)
    inertials, spheres, sc_spheres, jarm = [], [], [], []

    def walk(body, parent_idx):
        idx = len(names)
        names.append(body.get("name"))
        parents.append(parent_idx)
        gpos.append(_parse_vec(body.get("pos")))
        geom = body.find("geom")
        mesh_of.append(geom.get("mesh") if geom is not None and geom.get("type") == "mesh" else None)
        inertials.append(body.find("inertial"))
        spheres.append([_parse_vec(g.get("pos")) for g in body.findall("geom")
                        if g.get("type") == "sphere" and g.get("contype") != "0"])
        sc_spheres.append([(_parse_vec(g.get("pos")), float(g.get("size")))
                           for g in body.findall("geom")
                           if g.get("type") == "sphere" and g.get("contype") == "0"])
        joints = body.findall("joint")
        if parent_idx == -1:
            jranges.append(None)  # free joint
            jarm.append(None)
        else:
            rng = []
            for j in joints:  # z, y, x hinges
                r = _parse_vec(j.get("range", "-180 180"), 2)
                if angle_deg:
                    r = np.deg2rad(r)
                rng.append(r)
            jranges.append(np.array(rng))
            jarm.append([float(j.get("armature")) for j in joints]
                        if all(j.get("armature") for j in joints) else None)
        for child in body.findall("body"):
            walk(child, idx)

    world = root.find("worldbody")
    for body in world.findall("body"):
        walk(body, -1)

    nbody = len(names)
    gpos = np.array(gpos)
    # local offsets: child global pos minus parent global pos; root keeps its
    # global pos (mj body_pos[1], used by smpl_to_qpose count_offset). A
    # local-coordinate file gives the offsets themselves.
    body_pos = gpos.copy()
    if is_global:
        for i in range(1, nbody):
            body_pos[i] = gpos[i] - gpos[parents[i]]

    body_mass = np.zeros(nbody)
    body_ipos = np.zeros((nbody, 3))
    body_inertia = np.zeros((nbody, 3))
    body_iquat = np.tile([1.0, 0, 0, 0], (nbody, 1))
    K = max(contact_points_per_body, foot_contact_points)
    cpoints = np.zeros((nbody, K, 3))
    cmask = np.zeros((nbody, K))

    for i in range(nbody):
        mname = mesh_of[i]
        if mname is None or mname not in mesh_files:
            body_mass[i] = 1.0
            body_inertia[i] = 0.01
            continue
        tris = meshlib.load_stl(mesh_files[mname], native)
        m, com, I = meshlib.mesh_mass_properties(tris, density, native)
        diag, iq = meshlib.principal_inertia(I)
        # mesh vertices are in global zero-pose coords; body frame = global
        # frame translated to the body origin (identity body quats).
        origin = gpos[i] if is_global else np.zeros(3)
        body_mass[i] = m
        body_ipos[i] = com - origin
        body_inertia[i] = np.maximum(diag, 1e-8)
        body_iquat[i] = iq
        k = foot_contact_points if names[i] in ("L_Ankle", "R_Ankle", "L_Toe", "R_Toe") else contact_points_per_body
        verts = np.unique(tris.reshape(-1, 3), axis=0)
        pts = meshlib.convex_hull_points(verts, k) - origin
        cpoints[i, :k] = pts
        cmask[i, :k] = 1.0

    # an exported file's explicit mass properties and contact spheres
    for i in range(nbody):
        el = inertials[i]
        if el is not None:
            body_mass[i] = float(el.get("mass"))
            body_ipos[i] = _parse_vec(el.get("pos", "0 0 0"))
            body_iquat[i] = _parse_vec(el.get("quat", "1 0 0 0"), 4)
            body_inertia[i] = _parse_vec(el.get("diaginertia"))
        if spheres[i]:
            pts = np.asarray(spheres[i])[:K]
            cpoints[i] = 0.0
            cmask[i] = 0.0
            cpoints[i, :len(pts)] = pts
            cmask[i, :len(pts)] = 1.0

    topo = Topology(nbody=nbody, parents=tuple(parents), body_names=tuple(names))

    # self-collision sphere chains: SC spheres along each body's bone axis
    # (toward its first child; leaves use 2x the COM offset), radius = mean
    # perpendicular hull-vertex distance to the axis
    SC = 3
    fracs = np.array([0.25, 0.55, 0.85])
    sc_point = np.zeros((nbody, SC, 3))
    sc_radius = np.zeros(nbody)
    first_child = {}
    for i in range(1, nbody):
        first_child.setdefault(parents[i], i)
    for i in range(nbody):
        c = first_child.get(i)
        bone = (body_pos[c] if c is not None else 2.0 * body_ipos[i])
        blen = np.linalg.norm(bone)
        axis = bone / max(blen, 1e-6)
        sc_point[i] = fracs[:, None] * bone[None, :]
        mname = mesh_of[i]
        if mname is not None and mname in mesh_files:
            verts = np.unique(
                meshlib.load_stl(mesh_files[mname], native).reshape(-1, 3),
                axis=0)
            v = verts - (gpos[i] if is_global else 0.0)
            perp = v - np.outer(v @ axis, axis)
            sc_radius[i] = np.clip(
                np.mean(np.linalg.norm(perp, axis=1)), 0.02, 0.45 * max(blen, 0.05))
        else:
            sc_radius[i] = 0.03
        if sc_spheres[i]:
            sc_point[i] = [p for p, _ in sc_spheres[i][:SC]]
            sc_radius[i] = sc_spheres[i][0][1]

    armature = np.zeros(topo.nv)
    armature[6:] = armature_hinge
    for i in range(1, nbody):
        if jarm[i] is not None:
            armature[6 + 3 * (i - 1):6 + 3 * i] = jarm[i]
    jnt_range = np.concatenate([r for r in jranges if r is not None], axis=0)

    from benchmark.reference.frozen.smpl.constants import default_jkp_jkd_torque

    jkp, jkd, tq, a_scale = default_jkp_jkd_torque()
    if topo.ndof != len(jkp):  # non-SMPL-24 trees: pad with defaults
        jkp = np.full(topo.ndof, 50.0, np.float32)
        jkd = np.full(topo.ndof, 5.0, np.float32)
        tq = np.full(topo.ndof, 200.0, np.float32)
        a_scale = np.ones(topo.ndof, np.float32)

    model = Model(
        body_pos=body_pos.astype(np.float32),
        body_ipos=body_ipos.astype(np.float32),
        body_mass=body_mass.astype(np.float32),
        body_inertia=body_inertia.astype(np.float32),
        body_iquat=body_iquat.astype(np.float32),
        armature=armature.astype(np.float32),
        jkp=jkp, jkd=jkd, torque_lim=tq, a_scale=a_scale,
        jnt_range=jnt_range.astype(np.float32),
        contact_point=cpoints.astype(np.float32),
        contact_mask=cmask.astype(np.float32),
        sc_point=sc_point.astype(np.float32),
        sc_radius=sc_radius.astype(np.float32),
        friction=np.float32(friction),
        contact_stiffness=np.float32(contact_stiffness),
        contact_damping=np.float32(contact_damping),
        contact_depth_cap=np.float32(contact_depth_cap),
        contact_vreg=np.float32(contact_vreg),
        gravity=np.array([0.0, 0.0, -9.81], np.float32),
        dt=np.float32(1.0 / 450.0),
    )
    return topo, model
