"""ctypes binding of the port's native mesh toolkit (`meshtools.cpp`).

The library is compiled with g++ on first use into `uhc_tpu_torch/_build/`,
named by a hash of the source and the flags so that an edited source is
rebuilt and a stale library never loaded. A failed build raises with the
compiler's stderr: nothing falls back to the numpy versions in
`uhc_tpu_torch.smpl.mesh` on its own (the JAX package's binding returns
None there and its callers go on in numpy).

`mass_properties` rounds the triangles to float32, as the JAX binding
does, and the C++ sums each triangle's coordinates in float32 before it
accumulates in double: the mass agrees with the float64 numpy path, but
on meshes far from the origin the COM and the inertia about it do not
(on the stand-in: 5e-7 m and 6e-4 relative).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "meshtools.cpp")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
# the JAX package's Makefile flags (uhc_tpu/native/Makefile), so that both
# libraries compute the same bits
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib = None
build_log: dict = {}


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmeshtools_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is there -> its path. Raises when no
    compiler is found or the compile fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++) found to build the "
                           "native mesh toolkit")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"mesh toolkit build failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    # concurrent builds (test workers) each rename a whole file
    os.replace(tmp, out)
    build_log["command"] = cmd
    return out


def load():
    """The bound library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        u8, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(
            ctypes.c_float)
        lib.stl_tri_count.argtypes = [u8, ctypes.c_long]
        lib.stl_tri_count.restype = ctypes.c_int
        lib.stl_read.argtypes = [u8, ctypes.c_long, f32p]
        lib.stl_read.restype = ctypes.c_int
        lib.mass_properties.argtypes = [f32p, ctypes.c_int, ctypes.c_double,
                                        ctypes.POINTER(ctypes.c_double)]
        lib.mass_properties.restype = None
        lib.farthest_point_sample.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.farthest_point_sample.restype = None
        _lib = lib
    return _lib


def stl_tri_count(buf: bytes) -> int:
    """Triangles of a binary STL buffer, or -1 where it is not binary
    (ASCII STL)."""
    arr = np.frombuffer(buf, np.uint8)
    return load().stl_tri_count(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf))


def load_stl(path: str):
    """Binary STL -> (n, 3, 3) float64 triangles, or None for an ASCII
    file (which the numpy reader parses)."""
    with open(path, "rb") as f:
        buf = f.read()
    n = stl_tri_count(buf)
    if n < 0:
        return None
    arr = np.frombuffer(buf, np.uint8)
    out = np.empty((n, 9), np.float32)
    load().stl_read(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    len(buf),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.reshape(n, 3, 3).astype(np.float64)


def mass_properties(tris: np.ndarray, density: float = 1000.0):
    """(mass, com (3,), inertia about the COM (3, 3)) of a closed mesh's
    (n, 3, 3) triangles, rounded to float32 first."""
    t = np.ascontiguousarray(np.reshape(tris, (-1, 9)), np.float32)
    out = np.zeros(10, np.float64)
    load().mass_properties(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(t),
        float(density), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    inertia = np.array([[out[4], out[7], out[8]],
                        [out[7], out[5], out[9]],
                        [out[8], out[9], out[6]]])
    return out[0], out[1:4].copy(), inertia


def farthest_point_sample(pts: np.ndarray, k: int) -> np.ndarray:
    """k indices of (n, 3) points by farthest-point sampling, seeded at the
    lowest-z point (float32 distances)."""
    p = np.ascontiguousarray(pts, np.float32)
    idx = np.zeros(k, np.int32)
    load().farthest_point_sample(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(p), int(k),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return idx
