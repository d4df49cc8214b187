"""Build the port's CUDA kernels into shared libraries with a plain C
interface, loaded with ctypes.

The control-step source is compiled once per tree size: `-DNB=<bodies>`
fixes the body count (24 for the SMPL humanoid, 48 for masterfoot, 52 for
SMPL-H), so every library holds the same three kernels for one tree.
`load_library(nb)` compiles `control_step.cu` for sm_90a with nvcc (from
PATH or $CUDA_HOME/bin) on first use into `uhc_tpu_torch/_build/`, named by
a hash of the sources and flags so an edit rebuilds it; `build_libraries`
starts one nvcc per tree size at once and waits for all of them.
`load_host_library(nb)` compiles the same source as host C++ (each env on
one thread, no CUDA), which is how the CPU tests run the kernel's
arithmetic. A failed build raises with the compiler's stderr.
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
# (kind, nb) -> {"seconds", "stderr"} of the last build
build_log: dict = {}


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


def _command(kind: str, nb: int):
    """(output path, compile command) of one library."""
    if kind == "cuda":
        compiler, flags = find_nvcc(), NVCC_FLAGS
    else:
        compiler = shutil.which("g++") or shutil.which("c++")
        if compiler is None:
            raise RuntimeError("no host C++ compiler (g++) found")
        flags = HOST_FLAGS
    flags = [*flags, f"-DNB={int(nb)}"]
    out = os.path.join(BUILD_DIR, f"libuhc_{kind}_nb{nb}_{_hash(flags)}.so")
    return out, [compiler, *flags, "-o", f"{out}.{os.getpid()}.tmp",
                 *[os.path.join(HERE, s) for s in SOURCES]]


def _build_many(kind: str, nbs) -> dict:
    """Compile the missing libraries of `nbs`, all compilers at once ->
    {nb: path}. Each compiles to a private name and is renamed when done,
    so concurrent builds (test workers) never load a half-written one."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, running = {}, {}
    for nb in dict.fromkeys(nbs):
        out, cmd = _command(kind, nb)
        paths[nb] = out
        if not os.path.exists(out):
            running[nb] = (cmd, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    failed = []
    for nb, (cmd, t0, proc) in running.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"kernel build failed ({' '.join(cmd)}):\n{err}")
            continue
        os.replace(cmd[cmd.index("-o") + 1], paths[nb])
        build_log[kind, nb] = {"seconds": time.perf_counter() - t0,
                               "stderr": err}
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _bind(lib, suffix: str, stream: bool):
    """Declare the entry points: uhc_control_step (K1, K1e, K1d) takes 9
    pointers (model library, seq_idx or null, int table, 4 inputs, 2
    outputs), uhc_control_step_head / _tail (K2) take 10 (the last is
    Xp/Xf), then B, act_dim, rfc_rate. On CUDA each of them takes the
    matrix workspace (null at 24 bodies) before Xp/Xf and the stream
    last; the host build keeps its own workspace. uhc_control_step_f
    (K1f) takes K1's 9 pointers, on CUDA the workspace, the explicit
    wrench and the per-dof gain scales (either null), then B, act_dim,
    rfc_rate and, on CUDA, the stream."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for entry, nptr in (("uhc_control_step", 9),
                        ("uhc_control_step_head", 10),
                        ("uhc_control_step_tail", 10)):
        fn = getattr(lib, entry + suffix)
        fn.argtypes = ([ptr] * (nptr + (1 if stream else 0))
                       + [i32, i32, f32] + ([ptr] if stream else []))
        fn.restype = i32
    fn = getattr(lib, "uhc_control_step_f" + suffix)
    fn.argtypes = ([ptr] * (11 + (1 if stream else 0)) + [i32, i32, f32]
                   + ([ptr] if stream else []))
    fn.restype = i32
    lib.uhc_control_step_layout.argtypes = [ptr]
    lib.uhc_control_step_layout.restype = i32
    return lib


def build_libraries(nbs=(24,)) -> dict:
    """Build and load the CUDA libraries of every tree size in `nbs` (one
    nvcc each, all started together) -> {nb: library}."""
    missing = [nb for nb in nbs if ("cuda", nb) not in _loaded]
    if missing:
        for nb, path in _build_many("cuda", missing).items():
            _loaded["cuda", nb] = _bind(ctypes.CDLL(path), "", stream=True)
    return {nb: _loaded["cuda", nb] for nb in nbs}


def load_library(nb: int = 24):
    """The CUDA kernel library of the `nb`-body tree (built on first
    use)."""
    return build_libraries((nb,))[nb]


def load_host_library(nb: int = 24):
    """The same kernel source compiled as host C++ (for CPU tests); its
    entry points carry a `_host` suffix and take no stream."""
    if ("host", nb) not in _loaded:
        path = _build_many("host", (nb,))[nb]
        _loaded["host", nb] = _bind(ctypes.CDLL(path), "_host",
                                    stream=False)
    return _loaded["host", nb]


def layout(lib) -> dict:
    """Sizes the C side expects: params floats, table ints, shared-memory
    floats, threads per block, bodies, action columns it holds, the
    device workspace floats per env (0 where the matrices sit in shared
    memory), and K1f's shared-memory floats."""
    buf = (ctypes.c_int * 8)()
    lib.uhc_control_step_layout(buf)
    return {"params": buf[0], "itab": buf[1], "smem_floats": buf[2],
            "threads": buf[3], "nbody": buf[4], "maxact": buf[5],
            "workspace": buf[6], "smem_floats_k1f": buf[7]}
