"""Build the port's CUDA kernels into shared libraries with a plain C
interface, loaded with ctypes.

The control-step source is compiled once per tree size: `-DNB=<bodies>`
fixes the body count (any tree of up to 32 bodies, such as 24 for the SMPL
humanoid or 22 for remove_toe's tree, keeps an env's matrices in shared
memory; 48 for masterfoot, 52 for SMPL-H, 55 for SMPL-X use a device
workspace), so every library holds the same kernels for one tree.
`load_library(nb)` compiles `control_step.cu` for sm_90a with nvcc (from
PATH or $CUDA_HOME/bin) on first use into `uhc_tpu_torch/_build/`, named by
a hash of the sources and flags so an edit rebuilds it; `build_libraries`
starts one nvcc per tree size at once and waits for all of them.
`load_host_library(nb)` compiles the same source as host C++ (each env on
one thread, no CUDA), which is how the CPU tests run the kernel's
arithmetic. A failed build raises with the compiler's stderr.
`build_libraries(nbs, source)` builds another version of the source (a
file of another commit) beside this package's, so that the two can be
timed in turns on one card (chip_smoke.py --parent).
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
# library_key -> {"seconds", "stderr"} of the last build
build_log: dict = {}


def _hash(flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sources:
        with open(s, "rb") as f:
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


def library_key(kind: str, nb: int, source=None) -> tuple:
    """The key of one library in `build_log` (and the loaded libraries):
    (kind, nb) for this package's source, with another version's source
    after them."""
    return (kind, nb) if source is None else (kind, nb,
                                              os.path.abspath(source))


def _command(kind: str, nb: int, source=None):
    """(output path, compile command) of one library: this package's
    sources, or `source` in their place."""
    if kind == "cuda":
        compiler, flags = find_nvcc(), NVCC_FLAGS
    else:
        compiler = shutil.which("g++") or shutil.which("c++")
        if compiler is None:
            raise RuntimeError("no host C++ compiler (g++) found")
        flags = HOST_FLAGS
    flags = [*flags, f"-DNB={int(nb)}"]
    sources = ([os.path.abspath(source)] if source
               else [os.path.join(HERE, s) for s in SOURCES])
    out = os.path.join(BUILD_DIR, f"libuhc_{kind}_nb{nb}_"
                                  f"{_hash(flags, sources)}.so")
    return out, [compiler, *flags, "-o", f"{out}.{os.getpid()}.tmp",
                 *sources]


def _build_many(kind: str, nbs, source=None) -> dict:
    """Compile the missing libraries of `nbs` (of `source` where given),
    all compilers at once -> {nb: path}. Each compiles to a private name
    and is renamed when done, so concurrent builds (test workers) never
    load a half-written one."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, running = {}, {}
    for nb in dict.fromkeys(nbs):
        out, cmd = _command(kind, nb, source)
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
        build_log[library_key(kind, nb, source)] = {
            "seconds": time.perf_counter() - t0, "stderr": err}
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _bind(lib, suffix: str, stream: bool):
    """Declare the entry points: uhc_control_step (K1, K1e, K1d) and
    uhc_control_step_bf16 (K2b at split=False) take 9 pointers (model
    library, seq_idx or null, int table, 4 inputs, 2 outputs),
    uhc_control_step_head / _tail (K2) and their _bf16 twins (K2b) take
    10 (the last is Xp/Xf, float32 or bfloat16), then B, act_dim,
    rfc_rate. On CUDA each of them takes the matrix workspace (null on a
    tree of up to 32 bodies) before Xp/Xf, and after rfc_rate the floats
    of each of J6 and G by subtree (the int table's I_JROW[6·nb], which
    size such a tree's block of shared memory) and the stream; the host build keeps its own
    workspace, sized from the int table. uhc_control_step_f (K1f) takes
    K1's 9 pointers, on CUDA the workspace, the explicit wrench and the
    per-dof gain scales (either null), then B, act_dim, rfc_rate and, on
    CUDA, the J6 / G floats and the stream. The host build also has
    uhc_bf16_bits_host (x, out, n): K2b's rounding alone."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = [i32, i32, f32] + ([i32, ptr] if stream else [])
    for entry, nptr in (("uhc_control_step", 9),
                        ("uhc_control_step_head", 10),
                        ("uhc_control_step_tail", 10),
                        ("uhc_control_step_bf16", 9),
                        ("uhc_control_step_head_bf16", 10),
                        ("uhc_control_step_tail_bf16", 10),
                        ("uhc_control_step_f", 11)):
        fn = getattr(lib, entry + suffix)
        fn.argtypes = [ptr] * (nptr + (1 if stream else 0)) + ints
        fn.restype = i32
    if not stream:
        lib.uhc_bf16_bits_host.argtypes = [ptr, ptr, i32]
        lib.uhc_bf16_bits_host.restype = i32
    lib.uhc_control_step_layout.argtypes = [ptr]
    lib.uhc_control_step_layout.restype = i32
    return lib


def build_libraries(nbs=(24,), source=None) -> dict:
    """Build and load the CUDA libraries of every tree size in `nbs` (one
    nvcc each, all started together) -> {nb: library}: of this package's
    source, or of another version of it, `source`."""
    missing = [nb for nb in nbs
               if library_key("cuda", nb, source) not in _loaded]
    if missing:
        for nb, path in _build_many("cuda", missing, source).items():
            _loaded[library_key("cuda", nb, source)] = _bind(
                ctypes.CDLL(path), "", stream=True)
    return {nb: _loaded[library_key("cuda", nb, source)] for nb in nbs}


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
    floats (up to 32 bodies those before J6 and G, see `smem_floats`),
    threads per block, bodies, action columns it holds, the device
    workspace floats per env (0 where the matrices sit in shared memory),
    and K1f's shared-memory floats (as the other)."""
    buf = (ctypes.c_int * 8)()
    lib.uhc_control_step_layout(buf)
    return {"params": buf[0], "itab": buf[1], "smem_floats": buf[2],
            "threads": buf[3], "nbody": buf[4], "maxact": buf[5],
            "workspace": buf[6], "smem_floats_k1f": buf[7]}


def smem_floats(lib, jg: int) -> dict:
    """A block's shared-memory floats with `jg` floats in each of J6 and G
    by subtree (the int table's I_JROW[6·nb]; a big tree's do not depend
    on it): {"step": K1's and every other kernel's, "k1f": K1f's}."""
    buf = (ctypes.c_int * 2)()
    fn = lib.uhc_control_step_smem
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    fn(int(jg), buf)
    return {"step": buf[0], "k1f": buf[1]}


OCCUPANCY_ENTRIES = ("step", "k1f", "head", "tail", "step_bf16", "head_bf16",
                     "tail_bf16")


def occupancy(lib, jg: int = 0) -> dict:
    """What the card makes of each kernel of a CUDA library, with `jg`
    floats in each of J6 and G (up to 32 bodies; `smem_floats`): {entry:
    {"registers", "local_bytes" (a thread's stack frame and spills),
    "smem_bytes" (dynamic),
    "threads", "blocks_per_sm"}} from cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor. Raises on a CUDA
    error."""
    buf = (ctypes.c_int * (5 * len(OCCUPANCY_ENTRIES)))()
    fn = lib.uhc_control_step_occupancy
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    rc = fn(int(jg), buf)
    if rc != 0:
        raise RuntimeError(f"uhc_control_step_occupancy: CUDA error {rc}")
    keys = ("registers", "local_bytes", "smem_bytes", "threads",
            "blocks_per_sm")
    return {e: dict(zip(keys, buf[5 * n:5 * n + 5]))
            for n, e in enumerate(OCCUPANCY_ENTRIES)}
