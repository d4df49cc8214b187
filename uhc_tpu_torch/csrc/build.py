"""Build the port's CUDA kernels into shared libraries with a plain C
interface, loaded with ctypes.

`load_library()` compiles `control_step.cu` for sm_90a with nvcc (from PATH
or $CUDA_HOME/bin) on first use into `uhc_tpu_torch/_build/`, named by a
hash of the sources so an edit rebuilds it. `load_host_library()` compiles
the same source as host C++ (each env on one thread, no CUDA), which is how
the CPU tests run the kernel's arithmetic. A failed build raises with the
compiler's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
SOURCES = ("control_step.cu",)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC"]

_loaded: dict = {}
build_log: dict = {}     # kind -> {"seconds", "stderr"} of the last build


def _hash(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in SOURCES:
        with open(os.path.join(HERE, s), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or in $CUDA_HOME/bin")
    return nvcc


def _build(kind: str) -> str:
    if kind == "cuda":
        compiler, flags = find_nvcc(), NVCC_FLAGS
    else:
        compiler = shutil.which("g++") or shutil.which("c++")
        if compiler is None:
            raise RuntimeError("no host C++ compiler (g++) found")
        flags = HOST_FLAGS
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libuhc_{kind}_{_hash(flags)}.so")
    if os.path.exists(out):
        return out
    # compile to a private name, then rename: concurrent builds (test
    # workers) never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp,
           *[os.path.join(HERE, s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    build_log[kind] = {"seconds": time.perf_counter() - t0,
                       "stderr": proc.stderr}
    return out


def _bind(lib, suffix: str, stream: bool):
    """Declare the entry points: uhc_control_step (K1, K1e) takes 9
    pointers (model library, seq_idx or null, int table, 4 inputs, 2
    outputs), uhc_control_step_head / _tail (K2) take 10 (the last is
    Xp/Xf), then B, act_dim, rfc_rate and, on CUDA, the stream."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for entry, nptr in (("uhc_control_step", 9),
                        ("uhc_control_step_head", 10),
                        ("uhc_control_step_tail", 10)):
        fn = getattr(lib, entry + suffix)
        fn.argtypes = [ptr] * nptr + [i32, i32, f32] + ([ptr] if stream
                                                        else [])
        fn.restype = i32
    lib.uhc_control_step_layout.argtypes = [ptr]
    lib.uhc_control_step_layout.restype = i32
    return lib


def load_library():
    """The CUDA kernel library (built on first use)."""
    if "cuda" not in _loaded:
        _loaded["cuda"] = _bind(ctypes.CDLL(_build("cuda")), "", stream=True)
    return _loaded["cuda"]


def load_host_library():
    """The same kernel source compiled as host C++ (for CPU tests); its
    entry points carry a `_host` suffix and take no stream."""
    if "host" not in _loaded:
        _loaded["host"] = _bind(ctypes.CDLL(_build("host")), "_host",
                                stream=False)
    return _loaded["host"]


def layout(lib) -> dict:
    """Sizes the C side expects: params floats, table ints, shared-memory
    floats, threads per block."""
    buf = (ctypes.c_int * 4)()
    lib.uhc_control_step_layout(buf)
    return {"params": buf[0], "itab": buf[1], "smem_floats": buf[2],
            "threads": buf[3]}
