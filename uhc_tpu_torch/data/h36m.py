"""Human3.6M mocap pipeline (the port's own copy of uhc_tpu.data.h36m:
host numpy, run once per dataset, no torch).

* skeleton constants (names, offsets, parents, raw-pose addressing,
  channels);
* raw H36M D3_Angles poses (T, 78) -> MuJoCo qpos trajectories at 30 Hz
  (deg -> rad, angle wrap, linear resample, root mm -> m and rzxy euler ->
  quaternion, per-subject ground offset);
* skeleton offsets -> a capsule-geom MJCF humanoid (`h36m_mjcf_string`);
* CDF extraction (needs cdflib; the converter also takes the extracted
  dict).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from uhc_tpu_torch.data.mocap import interpolated_traj

# --- general euler -> quaternion (the classic transformations.py algorithm;
# the reference's quaternion_from_euler with axes='rzxy',
# convert_h36m_data.py:37) --------------------------------------------------

_NEXT_AXIS = [1, 2, 0, 1]
_AXES2TUPLE = {
    'sxyz': (0, 0, 0, 0), 'sxyx': (0, 0, 1, 0), 'sxzy': (0, 1, 0, 0),
    'sxzx': (0, 1, 1, 0), 'syzx': (1, 0, 0, 0), 'syzy': (1, 0, 1, 0),
    'syxz': (1, 1, 0, 0), 'syxy': (1, 1, 1, 0), 'szxy': (2, 0, 0, 0),
    'szxz': (2, 0, 1, 0), 'szyx': (2, 1, 0, 0), 'szyz': (2, 1, 1, 0),
    'rzyx': (0, 0, 0, 1), 'rxyx': (0, 0, 1, 1), 'ryzx': (0, 1, 0, 1),
    'rxzx': (0, 1, 1, 1), 'rxzy': (1, 0, 0, 1), 'ryzy': (1, 0, 1, 1),
    'rzxy': (1, 1, 0, 1), 'ryxy': (1, 1, 1, 1), 'ryxz': (2, 0, 0, 1),
    'rzxz': (2, 0, 1, 1), 'rxyz': (2, 1, 0, 1), 'rzyz': (2, 1, 1, 1)}


def _quat_from_euler(ai: float, aj: float, ak: float,
                     axes: str = 'sxyz') -> np.ndarray:
    firstaxis, parity, repetition, frame = _AXES2TUPLE[axes]
    i = firstaxis + 1
    j = _NEXT_AXIS[i + parity - 1] + 1
    k = _NEXT_AXIS[i - parity] + 1
    if frame:
        ai, ak = ak, ai
    if parity:
        aj = -aj
    ai, aj, ak = ai / 2.0, aj / 2.0, ak / 2.0
    ci, si = np.cos(ai), np.sin(ai)
    cj, sj = np.cos(aj), np.sin(aj)
    ck, sk = np.cos(ak), np.sin(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    q = np.empty(4)
    if repetition:
        q[0] = cj * (cc - ss)
        q[i] = cj * (cs + sc)
        q[j] = sj * (cc + ss)
        q[k] = sj * (cs - sc)
    else:
        q[0] = cj * cc + sj * ss
        q[i] = cj * sc - sj * cs
        q[j] = cj * ss + sj * cc
        q[k] = cj * cs - sj * sc
    if parity:
        q[j] *= -1.0
    return q

# --- h36m_specs.py constants -------------------------------------------------

NAMES = [
    'Hips', 'RightUpLeg', 'RightLeg', 'RightFoot', 'RightToeBase',
    'Site_RToe', 'LeftUpLeg', 'LeftLeg', 'LeftFoot', 'LeftToeBase',
    'Site_LToe', 'Spine', 'Spine1', 'Neck', 'Head', 'Site_Head',
    'LeftShoulder', 'LeftArm', 'LeftForeArm', 'LeftHand', 'LeftHandThumb',
    'Site_LThumb', 'LeftWrist', 'Site_LWrist', 'RightShoulder', 'RightArm',
    'RightForeArm', 'RightHand', 'RightHandThumb', 'Site_RThumb',
    'RightWrist', 'Site_RWrist']

_OFFSETS_CM = [
    [0.0, 0.0, 0.0], [-12.7193936, 0.0, 0.0], [0.0, -43.4291009, 0.0],
    [0.0, -44.8767017, 0.0], [0.0, 0.0, 15.1507021], [0.0, 0.0, 7.4999997],
    [12.719394, 0.0, 0.0], [0.0, -43.4291013, 0.0], [0.0, -44.8767017, 0.0],
    [0.0, 0.0, 15.1507012], [0.0, 0.0, 7.5000011], [0.0, 0.1, 0.0],
    [0.0, 24.5913012, 0.0], [0.0, 24.8462965, 0.0], [0.0, 9.2752478, 0.0],
    [0.0, 11.4999962, 0.0], [0.0, 24.8462965, 0.0], [0.0, 12.488198, 0.0],
    [0.0, 25.9758047, 0.0], [0.0, 24.5542024, 0.0], [0.0, 0.0, 0.0],
    [0.0, 0.0, 10.0], [0.0, 9.99999671, 0.0], [0.0, 0.0, 0.0],
    [0.0, 24.8462965, 0.0], [0.0, 12.4882004, 0.0], [0.0, 25.9757994, 0.0],
    [0.0, 24.5541986, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 9.999997],
    [0.0, 13.7500031, 0.0], [0.0, 0.0, 0.0]]

PARENT_IDX = [-1, 0, 1, 2, 3, 4, 0, 6, 7, 8, 9, 0, 11, 12, 13, 14, 12, 16,
              17, 18, 19, 20, 19, 22, 12, 24, 25, 26, 27, 28, 27, 30]

# raw D3_Angles pose addressing (h36m_specs.py bone_addr; note the gaps —
# e.g. index 9 between RightUpLeg and RightLeg is unused in the raw layout)
BONE_ADDR = {
    'Hips': (0, 6), 'RightUpLeg': (6, 9), 'RightLeg': (10, 11),
    'RightFoot': (12, 15), 'RightToeBase': (15, 18), 'LeftUpLeg': (18, 21),
    'LeftLeg': (22, 23), 'LeftFoot': (24, 27), 'LeftToeBase': (27, 30),
    'Spine': (30, 33), 'Spine1': (33, 36), 'Neck': (36, 39),
    'Head': (39, 42), 'LeftShoulder': (42, 45), 'LeftArm': (45, 48),
    'LeftForeArm': (49, 50), 'LeftHand': (51, 54),
    'LeftHandThumb': (54, 57), 'LeftWrist': (57, 60),
    'RightShoulder': (60, 63), 'RightArm': (63, 66),
    'RightForeArm': (67, 68), 'RightHand': (69, 72),
    'RightHandThumb': (72, 75), 'RightWrist': (75, 78)}

EXCLUDE_BONES = {'Thumb', 'Site', 'Wrist', 'Toe'}
CHANNELS = ['z', 'x', 'y']
SPEC_CHANNELS = {'LeftForeArm': ['x'], 'RightForeArm': ['x'],
                 'LeftLeg': ['x'], 'RightLeg': ['x']}

# per-subject ground-height fixes (convert_h36m_data.py:28)
SUBJECT_Z_OFFSETS = {'S1': -0.025, 'S6': -0.117, 'S7': -0.02, 'S8': -0.045,
                     'S9': -0.075, 'S11': -0.067}


def h36m_offsets() -> Dict[str, np.ndarray]:
    """Name -> parent-frame offset (cm), left/right symmetrized exactly as
    h36m_specs.py does at import time."""
    offs = {NAMES[i]: np.asarray(x, np.float64)
            for i, x in enumerate(_OFFSETS_CM)}
    for bone in NAMES:
        if 'Left' in bone:
            symm = bone.replace('Left', 'Right')
            ol, orr = offs[bone], offs[symm]
            sl = ol / (np.abs(ol) + 1e-12)
            sr = orr / (np.abs(orr) + 1e-12)
            new = (np.abs(ol) + np.abs(orr)) * 0.5
            offs[bone] = sl * new
            offs[symm] = sr * new
    return offs


def _included(name: str) -> bool:
    return not any(x in name for x in EXCLUDE_BONES)


def model_bones() -> List[str]:
    """Bodies of the generated humanoid in MJCF (depth-first) order — the
    order Skeleton.load_from_offsets emits nested <body> elements, which
    fixes the model's qpos addressing (get_body_qposaddr)."""
    children: Dict[str, List[str]] = {n: [] for n in NAMES}
    for i, p in enumerate(PARENT_IDX):
        if p >= 0 and _included(NAMES[i]):
            children[NAMES[p]].append(NAMES[i])
    order: List[str] = []

    def dfs(n):
        order.append(n)
        for c in children[n]:
            dfs(c)

    dfs(NAMES[0])
    return order


def bone_channels(name: str) -> List[str]:
    return SPEC_CHANNELS.get(name, CHANNELS)


def body_qposaddr() -> Dict[str, Tuple[int, int]]:
    """Model-side qpos address ranges (get_body_qposaddr equivalent,
    khrylib/utils math — root free joint 7, then per-bone hinge channels)."""
    addr, i = {}, 0
    for name in model_bones():
        if name == 'Hips':
            addr[name] = (0, 7)
            i = 7
        else:
            n = len(bone_channels(name))
            addr[name] = (i, i + n)
            i += n
    return addr


def h36m_nq() -> int:
    a = body_qposaddr()
    return max(e for _, e in a.values())


def angle_fix(poses: np.ndarray, start_ind: int) -> np.ndarray:
    """Wrap all angle columns into (-pi, pi] (convert_h36m_data.py:56)."""
    poses = poses.copy()
    pt = poses[:, start_ind:]
    while np.any(pt > np.pi):
        pt[pt > np.pi] -= 2 * np.pi
    while np.any(pt < -np.pi):
        pt[pt < -np.pi] += 2 * np.pi
    poses[:, start_ind:] = pt
    return poses


def get_qpos(pose: np.ndarray) -> np.ndarray:
    """One raw H36M pose (78,) -> model qpos (convert_h36m_data.py:31):
    root = trans mm->m + rzxy euler->quat; hinge bones copy their raw angle
    channels straight through."""
    qpos = np.zeros(h36m_nq())
    maddr = body_qposaddr()
    for bone, (m0, m1) in maddr.items():
        r0, r1 = BONE_ADDR[bone]
        if m0 == 0:
            trans = pose[r0:r0 + 3] * 0.001
            ang = pose[r0 + 3:r1]
            quat = _quat_from_euler(ang[0], ang[1], ang[2], 'rzxy')
            qpos[0:3] = trans
            qpos[3:7] = quat
        else:
            qpos[m0:m1] = pose[r0:r1][: m1 - m0]
    return qpos


def get_qpos_traj(poses: np.ndarray, mocap_fr: int = 50, dt: float = 1 / 30,
                  offset_z: float = 0.0) -> np.ndarray:
    """(T_raw, 78) degrees at mocap_fr -> (T_30hz, nq) qpos
    (convert_h36m_data.py:63 get_qpos_traj)."""
    poses = poses.astype(np.float64).copy()
    poses[:, 3:] = np.deg2rad(poses[:, 3:])
    poses = angle_fix(poses, 3)
    poses_samp = interpolated_traj(poses, dt, mocap_fr=mocap_fr)
    qpos_traj = np.vstack([get_qpos(p) for p in poses_samp])
    qpos_traj[:, 2] += offset_z
    return qpos_traj


def convert_h36m_dict(orig_data: Dict[str, Dict[str, np.ndarray]],
                      mocap_fr: int = 50, dt: float = 1 / 30
                      ) -> Dict[str, Dict[str, np.ndarray]]:
    """{subject: {action: raw poses}} -> {subject: {action: qpos traj}}
    (convert_h36m_data.py main loop)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for subject, s_data in orig_data.items():
        out[subject] = {}
        oz = SUBJECT_Z_OFFSETS.get(subject, 0.0)
        for action, poses in s_data.items():
            out[subject][action] = get_qpos_traj(np.asarray(poses),
                                                 mocap_fr, dt, oz)
    return out


def load_h36m_raw(raw_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """CDF D3_Angles extraction (convert_h36m_raw.py). Requires cdflib,
    which is not baked into this image — gated import."""
    try:
        import cdflib  # noqa: F401
    except ImportError as e:  # pragma: no cover - env-gated
        raise ImportError(
            "cdflib is required to read raw H36M .cdf files; pass the "
            "already-extracted {subject: {action: poses}} dict to "
            "convert_h36m_dict instead") from e
    import glob
    import os

    data: Dict[str, Dict[str, np.ndarray]] = {}
    for subject in ['S1', 'S5', 'S6', 'S7', 'S8', 'S9', 'S11']:
        data[subject] = {}
        files = sorted(glob.glob(
            f"{raw_dir}/{subject}/MyPoseFeatures/D3_Angles/*.cdf"))
        for f in files:
            action = os.path.splitext(os.path.basename(f))[0]
            cdf = cdflib.CDF(f)
            data[subject][action] = cdf.varget("Pose").squeeze(0)
    return data


# --- create_h36m_humanoid.py equivalent --------------------------------------

_AXES = {'x': '1 0 0', 'y': '0 1 0', 'z': '0 0 1'}


def h36m_mjcf_string(offset=np.array([0.0, 0.0, 1.0]),
                     bone_scale: float = 0.01, geom_radius: float = 0.04,
                     timestep: float = 1 / 450) -> str:
    """Capsule-geom MJCF humanoid from the H36M skeleton offsets —
    Skeleton.load_from_offsets(offsets, parents, 0.01, exclude_bones,
    channels, spec_channels) + write_xml (create_h36m_humanoid.py:17-20).

    Each bone gets one hinge joint per channel (range unlimited like the
    reference Skeleton writer) and a capsule from its origin toward each
    child's offset."""
    offs = h36m_offsets()
    children: Dict[str, List[str]] = {n: [] for n in NAMES}
    for i, p in enumerate(PARENT_IDX):
        if p >= 0 and _included(NAMES[i]):
            children[NAMES[p]].append(NAMES[i])

    lines = [
        "<mujoco model=\"human36m\">",
        f"  <option timestep=\"{timestep:.6f}\" iterations=\"50\"/>",
        "  <compiler angle=\"radian\"/>",
        "  <worldbody>",
        "    <geom name=\"floor\" type=\"plane\" size=\"10 10 0.1\"/>",
    ]

    def emit(name: str, depth: int):
        ind = "    " * depth
        pos = (np.asarray(offs[name]) * bone_scale
               if name != 'Hips' else np.asarray(offset, np.float64))
        lines.append(f"{ind}<body name=\"{name}\" pos=\""
                     f"{pos[0]:.6f} {pos[1]:.6f} {pos[2]:.6f}\">")
        if name == 'Hips':
            lines.append(f"{ind}  <joint name=\"Hips\" type=\"free\"/>")
        else:
            for ch in bone_channels(name):
                lines.append(
                    f"{ind}  <joint name=\"{name}_{ch}\" type=\"hinge\" "
                    f"axis=\"{_AXES[ch]}\" damping=\"1\"/>")
        kids = children[name]
        if kids:
            for c in kids:
                e = np.asarray(offs[c]) * bone_scale
                if np.linalg.norm(e) < 1e-6:
                    continue
                lines.append(
                    f"{ind}  <geom type=\"capsule\" fromto=\"0 0 0 "
                    f"{e[0]:.6f} {e[1]:.6f} {e[2]:.6f}\" "
                    f"size=\"{geom_radius}\"/>")
        else:
            lines.append(f"{ind}  <geom type=\"sphere\" "
                         f"size=\"{geom_radius}\"/>")
        for c in kids:
            emit(c, depth + 1)
        lines.append(f"{ind}</body>")

    emit('Hips', 2)
    lines += ["  </worldbody>", "</mujoco>"]
    return "\n".join(lines)
