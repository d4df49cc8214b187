"""Legacy mocap import, BVH and AMC (the port's own copy of
uhc_tpu.data.mocap: host numpy, no torch).

One-time ETL on the host: parse a BVH or AMC file into a (T, dof) pose
matrix and a per-bone address map, then resample to the control rate with
`interpolated_traj`. The BVH parser is self-contained (HIERARCHY offsets
and channels, then MOTION frames, is all the format has).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


def load_amc_file(fname: str, scale: float):
    """CMU .amc -> (poses (T, dof), bone_addr) (pose.py:7-41): root gets
    [xyz*scale, radians(euler)], other bones reversed radian channels;
    single-channel feet are padded to 2 dofs."""
    with open(fname) as f:
        content = f.readlines()
    bone_addr: Dict[str, Tuple[int, int]] = {}
    poses: List[np.ndarray] = []
    cur_pos: Optional[list] = None
    fr = 1
    for line in content:
        words = line.split()
        if not words:
            continue
        cmd = words[0]
        if cmd == str(fr):
            if cur_pos:
                poses.append(np.array(cur_pos))
            cur_pos = []
            fr += 1
        elif cur_pos is not None:
            start = len(cur_pos)
            if cmd == "root":
                cur_pos += [float(w) * scale for w in words[1:4]]
                cur_pos += [math.radians(float(w)) for w in words[4:]]
            elif cmd in ("lfoot", "rfoot"):
                cur_pos += list(reversed(
                    [math.radians(float(w)) for w in words[1:]]))
                if len(cur_pos) - start < 2:
                    cur_pos.insert(-1, 0.0)
            else:
                cur_pos += list(reversed(
                    [math.radians(float(w)) for w in words[1:]]))
            if fr == 2:
                bone_addr[cmd] = (start, len(cur_pos))
    if cur_pos:
        poses.append(np.array(cur_pos))
    return np.vstack(poses), bone_addr


class BvhJoint:
    def __init__(self, name: str):
        self.name = name
        self.offset = np.zeros(3)
        self.channels: List[str] = []
        self.children: List["BvhJoint"] = []


def parse_bvh(text: str):
    """Minimal BVH parser -> (joints in file order, frames (T, total_ch),
    frame_time)."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    i = 0
    joints: List[BvhJoint] = []
    stack: List[BvhJoint] = []
    frames = []
    frame_time = 1.0 / 120.0
    n_frames = 0
    while i < len(lines):
        ln = lines[i]
        tok = ln.split()
        if tok[0] in ("ROOT", "JOINT"):
            j = BvhJoint(tok[1])
            if stack:
                stack[-1].children.append(j)
            joints.append(j)
            stack.append(j)
        elif tok[0] == "End":
            stack.append(BvhJoint(stack[-1].name + "_End"))
        elif tok[0] == "OFFSET":
            stack[-1].offset = np.array([float(x) for x in tok[1:4]])
        elif tok[0] == "CHANNELS":
            stack[-1].channels = tok[2:2 + int(tok[1])]
        elif tok[0] == "}":
            stack.pop()
        elif tok[0] == "Frames:":
            n_frames = int(tok[1])
        elif tok[0] == "Frame" and tok[1] == "Time:":
            frame_time = float(tok[2])
            for k in range(i + 1, i + 1 + n_frames):
                frames.append([float(x) for x in lines[k].split()])
            i = i + n_frames
        i += 1
    return joints, np.asarray(frames), frame_time


def load_bvh_file(fname: str, len_scale: float = 0.01):
    """BVH -> (poses (T, dof), bone_addr) (pose.py:44-70): root translation
    scaled, all rotations to radians; channel order preserved per bone."""
    with open(fname) as f:
        joints, frames, frame_time = parse_bvh(f.read())
    bone_addr: Dict[str, Tuple[int, int]] = {}
    start = 0
    for j in joints:
        bone_addr[j.name] = (start, start + len(j.channels))
        start += len(j.channels)
    poses = np.array(frames, dtype=np.float64)
    for j in joints:
        a, b = bone_addr[j.name]
        for c in range(a, b):
            ch = j.channels[c - a]
            if ch.endswith("position"):
                poses[:, c] *= len_scale
            else:
                poses[:, c] = np.deg2rad(poses[:, c])
    return poses, bone_addr, frame_time


def lin_interp(pose1: np.ndarray, pose2: np.ndarray, t: float):
    """Linear pose interpolation with angle-jump snap (pose.py:73)."""
    pose_t = (1 - t) * pose1 + t * pose2
    if np.any(np.abs(pose2[3:] - pose1[3:]) > np.pi * 0.5):
        pose_t[3:] = pose1[3:] if t < 0.5 else pose2[3:]
    return pose_t


def interpolated_traj(poses: np.ndarray, sample_t: float = 0.030,
                      mocap_fr: float = 120, interp_func=lin_interp):
    """Resample a mocap trajectory to the control period (pose.py:80)."""
    N = poses.shape[0]
    T = float(N - 1) / mocap_fr
    num = int(math.floor(T / sample_t))
    sampling_times = np.arange(num + 1) * sample_t * mocap_fr
    out = []
    for t in sampling_times:
        start = int(math.floor(t))
        end = min(int(math.ceil(t)), N - 1)
        out.append(interp_func(poses[start], poses[end], t - math.floor(t)))
    return np.vstack(out)
