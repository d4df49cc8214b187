"""MJCF export (PyTorch port's copy of uhc_tpu.smpl.mjcf_export): a
local-coordinate MuJoCo XML from (Topology, Model) arrays.

The reference writes its robots as MJCF through lxml tree builders
(uhc/khrylib/mocap/skeleton_mesh.py:131 write_str, smpl_robot.py:1487
export_xml_string) in the legacy global-coordinate format. This exporter
serializes the engine's array model into local-coordinate MJCF that MuJoCo
>= 2.3.4 loads, with explicit inertials, so that the simulated mass
properties are exactly the engine's. `uhc_tpu_torch.smpl.mjcf
.load_mjcf_humanoid` reads the file back (topology, offsets, mass
properties, armature, joint ranges, contact and self-collision spheres).

Geoms are spheres at the engine's contact candidate points (its collision
proxy), of radius `contact_radius`; bodies collide with the floor only
(contype / conaffinity masks), as the engine's ground-plane contact does.
A model of tensors is read through `numpy_model`.
"""
from __future__ import annotations

import io

import numpy as np

from uhc_tpu_torch.physics.model import Model, Topology, numpy_model


def _fmt(a) -> str:
    return " ".join(f"{float(x):.8g}" for x in np.atleast_1d(np.asarray(a)))


def export_mjcf(topo: Topology, model: Model, name: str = "humanoid",
                contact_radius: float = 0.012, floor: bool = True,
                actuators: bool = True,
                self_collision: bool = False) -> str:
    """Serialize (topo, model) to a local-coordinate MJCF string.

    With `self_collision=True`, the engine's SC spheres (model.sc_point /
    sc_radius) are emitted as contype=0 geoms wired into explicit
    <contact><pair> elements over the curated body-pair set
    (smpl.constants.self_collision_pairs) — so CPU MuJoCo simulates EXACTLY
    the engine's body-body contact candidates (the oracle for calibrating
    engine.self_collision_terms k/d)."""
    model = numpy_model(model)
    m = {f: np.asarray(getattr(model, f)) for f in (
        "body_pos", "body_ipos", "body_mass", "body_inertia", "body_iquat",
        "armature", "jnt_range", "contact_point", "contact_mask")}
    dt = float(np.asarray(model.dt))
    grav = np.asarray(model.gravity)

    out = io.StringIO()
    w = out.write
    w(f'<mujoco model="{name}">\n')
    w('  <compiler coordinate="local" angle="radian" '
      'inertiafromgeom="false"/>\n')
    w(f'  <option timestep="{dt:.10g}" gravity="{_fmt(grav)}" '
      'integrator="Euler"/>\n')
    w('  <default>\n')
    w('    <joint limited="true" damping="0" stiffness="0"/>\n')
    w(f'    <geom condim="3" friction="{float(np.asarray(model.friction)):g}'
      ' 0.0 0.0" contype="1" conaffinity="2"/>\n')
    w('  </default>\n')
    w('  <worldbody>\n')
    if floor:
        w('    <geom name="floor" type="plane" size="50 50 1" '
          'pos="0 0 0" contype="2" conaffinity="1"/>\n')

    children = {i: [] for i in range(-1, topo.nbody)}
    for i in range(topo.nbody):
        children[topo.parents[i]].append(i)

    arm = m["armature"]

    def emit(i: int, indent: str):
        w(f'{indent}<body name="{topo.body_names[i]}" '
          f'pos="{_fmt(m["body_pos"][i])}">\n')
        w(f'{indent}  <inertial pos="{_fmt(m["body_ipos"][i])}" '
          f'quat="{_fmt(m["body_iquat"][i])}" '
          f'mass="{float(m["body_mass"][i]):.8g}" '
          f'diaginertia="{_fmt(m["body_inertia"][i])}"/>\n')
        if i == 0:
            w(f'{indent}  <freejoint name="root"/>\n')
        elif topo.joint_kind == "ball":
            # quaternion joint family (SkeletonMeshV2: unlimited ball joint)
            w(f'{indent}  <joint name="{topo.body_names[i]}" type="ball" '
              f'limited="false" '
              f'armature="{float(arm[6 + 3 * (i - 1)]):.8g}"/>\n')
        else:
            base = 3 * (i - 1)
            axes = ("0 0 1", "0 1 0", "1 0 0")
            tags = ("z", "y", "x")
            for k in range(3):
                r = m["jnt_range"][base + k]
                w(f'{indent}  <joint name="{topo.body_names[i]}_{tags[k]}" '
                  f'type="hinge" axis="{axes[k]}" range="{_fmt(r)}" '
                  f'armature="{float(arm[6 + base + k]):.8g}"/>\n')
        # contact proxy spheres at the engine's candidate points
        cp, cm = m["contact_point"][i], m["contact_mask"][i]
        for k in range(cp.shape[0]):
            if cm[k] > 0:
                w(f'{indent}  <geom name="{topo.body_names[i]}_c{k}" '
                  f'type="sphere" size="{contact_radius:g}" '
                  f'pos="{_fmt(cp[k])}"/>\n')
        if self_collision:
            scp = np.asarray(model.sc_point)[i]
            scr = float(np.asarray(model.sc_radius)[i])
            for k in range(scp.shape[0]):
                w(f'{indent}  <geom name="{topo.body_names[i]}_s{k}" '
                  f'type="sphere" size="{scr:g}" pos="{_fmt(scp[k])}" '
                  'contype="0" conaffinity="0"/>\n')
        for c in children[i]:
            emit(c, indent + "  ")
        w(f'{indent}</body>\n')

    emit(0, "    ")
    w('  </worldbody>\n')
    if self_collision:
        from uhc_tpu_torch.smpl.constants import self_collision_pairs
        SC = np.asarray(model.sc_point).shape[1]
        w('  <contact>\n')
        for a, b in self_collision_pairs(topo):
            for ka in range(SC):
                for kb in range(SC):
                    w(f'    <pair geom1="{topo.body_names[a]}_s{ka}" '
                      f'geom2="{topo.body_names[b]}_s{kb}" condim="1"/>\n')
        w('  </contact>\n')
    if actuators and topo.joint_kind == "ball":
        actuators = False          # ball family is torque-driven externally
    if actuators:
        w('  <actuator>\n')
        a_scale = np.asarray(model.a_scale)
        for i in range(1, topo.nbody):
            for k, tag in enumerate(("z", "y", "x")):
                j = 3 * (i - 1) + k
                w(f'    <motor joint="{topo.body_names[i]}_{tag}" '
                  f'gear="{float(a_scale[j]):.8g}"/>\n')
        w('  </actuator>\n')
    w('</mujoco>\n')
    return out.getvalue()


_VIS_COLORS = ("0.7 0.0 0.0 1", "0.0 0.6 0.0 1", "0.0 0.0 0.8 1",
               "0.8 0.6 0.0 1", "0.5 0.0 0.8 1", "0.0 0.6 0.6 1")


def export_vis_mjcf(topo: Topology, model: Model, num: int = 2,
                    name: str = "humanoid_vis",
                    contact_radius: float = 0.012) -> str:
    """Multi-humanoid visualization scene — smpl_robot.py:1490
    export_vis_string: `num` color-coded copies of the robot, each with its
    own free root + joints but NO contacts and NO actuators (the reference's
    vis models are pose-playback only; CopycatVisualizer drives one copy
    with the sim pose and one with the expert)."""
    model = numpy_model(model)
    m = {f: np.asarray(getattr(model, f)) for f in (
        "body_pos", "body_ipos", "body_mass", "body_inertia", "body_iquat",
        "jnt_range", "contact_point", "contact_mask")}
    out = io.StringIO()
    w = out.write
    w(f'<mujoco model="{name}">\n')
    w('  <compiler coordinate="local" angle="radian" '
      'inertiafromgeom="false"/>\n')
    w('  <option timestep="0.0022222222"/>\n')
    w('  <default>\n')
    w('    <joint limited="false" damping="0" stiffness="0"/>\n')
    w('    <geom condim="1" contype="0" conaffinity="0"/>\n')
    w('  </default>\n')
    w('  <worldbody>\n')
    w('    <geom name="floor" type="plane" size="50 50 1" pos="0 0 0"/>\n')

    children = {i: [] for i in range(-1, topo.nbody)}
    for i in range(topo.nbody):
        children[topo.parents[i]].append(i)

    def emit(i: int, indent: str, suffix: str, rgba: str):
        w(f'{indent}<body name="{topo.body_names[i]}{suffix}" '
          f'pos="{_fmt(m["body_pos"][i])}">\n')
        w(f'{indent}  <inertial pos="{_fmt(m["body_ipos"][i])}" '
          f'quat="{_fmt(m["body_iquat"][i])}" '
          f'mass="{float(m["body_mass"][i]):.8g}" '
          f'diaginertia="{_fmt(m["body_inertia"][i])}"/>\n')
        if i == 0:
            w(f'{indent}  <freejoint name="root{suffix}"/>\n')
        elif topo.joint_kind == "ball":
            w(f'{indent}  <joint name="{topo.body_names[i]}{suffix}" '
              'type="ball"/>\n')
        else:
            axes = ("0 0 1", "0 1 0", "1 0 0")
            for k, tag in enumerate(("z", "y", "x")):
                w(f'{indent}  <joint '
                  f'name="{topo.body_names[i]}{suffix}_{tag}" '
                  f'type="hinge" axis="{axes[k]}"/>\n')
        cp, cm = m["contact_point"][i], m["contact_mask"][i]
        for k in range(cp.shape[0]):
            if cm[k] > 0:
                w(f'{indent}  <geom type="sphere" '
                  f'size="{contact_radius:g}" pos="{_fmt(cp[k])}" '
                  f'rgba="{rgba}"/>\n')
        for c in children[i]:
            emit(c, indent + "  ", suffix, rgba)
        w(f'{indent}</body>\n')

    for h in range(num):
        emit(0, "    ", f"_{h}" if h else "",
             _VIS_COLORS[h % len(_VIS_COLORS)])
    w('  </worldbody>\n')
    w('</mujoco>\n')
    return out.getvalue()
