"""The big-tree control step's exact inverse pair, on the CPU: the CUDA
source built as host C++ at 48, 52 and 55 bodies (masterfoot, SMPL-H,
SMPL-X), where Xp and Xf live in shared memory as packed lower triangles
and are factored and inverted there. K2's head writes them out in full:
they are held against the float64 plain inverses by chip_smoke's
`x_check`; every output of the host builds (K1d, K1f, K2 head with its
Xp/Xf and tail, K2b, K1g) keeps the digests of the source as it was before
the inverses moved to shared memory; and each build's layout fits a
block's shared memory, two blocks an SM at 24 bodies on the SMPL tree.
States are clip frames of the gait clips on each tree (chip_smoke's
draws, seeded)."""
import dataclasses
import hashlib
import shutil

import numpy as np
import pytest
import torch

from test_torch_helpers import few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

FAMILIES = {"masterfoot": 48, "smplh": 52, "smplx": 55}
# a block's shared memory on the H100 (227 KB); an SM's (228 KB), and
# what the SM reserves for each resident block
SMEM_BYTES = 232_448
SM_BYTES, BLOCK_RESERVED = 233_472, 1_024
# (body, dof) pairs of the SMPL tree with the dof above the body: the
# columns of J6 and G by subtree, 6 rows each
SMPL_PAIRS = 429
N_DIGEST = 4
# sha256 (first 16 hex digits) of the host build's outputs as the source
# was before the big-tree inverses moved to shared memory: K1d at (2, 2),
# K2 head (qpos, qvel, Xp/Xf) and tail at PCG-2, K2b (head, Xp/Xf, tail;
# split=False), K1g (refresh_at=8) in plain PD (meta0) and meta-PD
# (meta1), and K1f explicit and meta_joint, on seeded clip-frame draws
PARENT_DIGESTS = {
    "smplh_meta0_k1d": "bb1932cd043baf7f",
    "smplh_meta0_head": "ee7ac0d926e36f8c",
    "smplh_meta0_tail": "bb1932cd043baf7f",
    "smplh_meta0_k2b": "06803a0f55cc31ff",
    "smplh_meta0_k2b_one": "429499e729c1dea2",
    "smplh_meta0_k1g": "a1bcb0b4b282be30",
    "smplh_meta1_k1d": "6558507e62dc81a7",
    "smplh_meta1_head": "2af9c5afc2acb97d",
    "smplh_meta1_tail": "6558507e62dc81a7",
    "smplh_meta1_k2b": "fd091a7877254720",
    "smplh_meta1_k2b_one": "45cc7b1d792a9ff4",
    "smplh_meta1_k1g": "ab310ac062eb9259",
    "smplh_explicit_k1f": "5b7b2f4effdb0675",
    "smplh_meta_joint_k1f": "b02caf87cb0e5be4",
    "masterfoot_meta0_k1d": "81aa0d48a4eed9fb",
    "masterfoot_meta0_head": "504063a447d5b58a",
    "masterfoot_meta0_tail": "81aa0d48a4eed9fb",
    "masterfoot_meta0_k2b": "dce1a2d2761c7f2d",
    "masterfoot_meta0_k2b_one": "64aab6405370dd32",
    "masterfoot_meta0_k1g": "573f88b3c6de8db2",
    "masterfoot_meta1_k1d": "82f0f396f5a571ef",
    "masterfoot_meta1_head": "89d40368c9a44d1a",
    "masterfoot_meta1_tail": "82f0f396f5a571ef",
    "masterfoot_meta1_k2b": "9037c60dc47b2a5f",
    "masterfoot_meta1_k2b_one": "6b76e9e2b4dc4073",
    "masterfoot_meta1_k1g": "5799b9e942dbdd88",
    "masterfoot_explicit_k1f": "56cd35de27c33e9c",
    "masterfoot_meta_joint_k1f": "087159446f62b0f6",
    "smplx_meta0_k1d": "fddb9985775daf49",
    "smplx_meta0_head": "b9d238e221acd87d",
    "smplx_meta0_tail": "fddb9985775daf49",
    "smplx_meta0_k2b": "69c17702b6bec7fc",
    "smplx_meta0_k2b_one": "bab261903d5d279d",
    "smplx_meta0_k1g": "a4c7782560ef0a19",
    "smplx_meta1_k1d": "944e1e5f1a51f42d",
    "smplx_meta1_head": "da6aff2d34770e4c",
    "smplx_meta1_tail": "944e1e5f1a51f42d",
    "smplx_meta1_k2b": "2613034fb0ee0338",
    "smplx_meta1_k2b_one": "14132c1d805f8fc0",
    "smplx_meta1_k1g": "b185efb27ef4abdc",
}


def _host(nb):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from uhc_tpu_torch.csrc import build

    return build.load_host_library(nb)


@pytest.fixture(scope="module")
def trees():
    """{family: (topo, env cfg, model, expert library)} on the CPU."""
    import chip_smoke as C

    out = {}
    for fam in FAMILIES:
        out[fam] = (C.smplx_tree("cpu") if fam == "smplx"
                    else C.big_tree(fam, "cpu"))
    return out


def _ptrs(*arrays):
    return [None if a is None else a.ctypes.data for a in arrays]


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _host_head(lib, step, ins):
    """The host build's K2 head on numpy `ins` -> (qpos, qvel, X)."""
    n, nv = ins[0].shape[0], step.topo.nv
    qm, vm = np.zeros_like(ins[0]), np.zeros_like(ins[1])
    X = np.zeros((n, 2, nv, nv), np.float32)
    assert lib.uhc_control_step_head_host(
        step.params.ctypes.data, None, step.itab.ctypes.data,
        *_ptrs(*ins, qm, vm, X), n, step.act_dim, 1.0) == 0
    return qm, vm, X


@pytest.mark.parametrize("family", list(FAMILIES))
def test_host_head_inverses_match_plain64(trees, family):
    """K2's head on each big tree (host build, 8 clip-frame states, plain
    PD and meta-PD): its Xp/Xf against the float64 plain exact inverses of
    A_pd, A_fd at substep 0 by chip_smoke's `x_check` (1e-4 of max|X| of
    each matrix, or twice the float32 plain inverses' own reading where
    those miss it), the rule of the k2_big and k2_smplx phases on the
    card."""
    import chip_smoke as C
    from uhc_tpu_torch.physics import control_step_split as K2

    topo, env, model, lib = trees[family]
    host = _host(topo.nbody)
    gen = torch.Generator().manual_seed(41)
    qpos, qvel, tb = C.draw_big_states(lib, topo.nv, 8, gen, "cpu")
    for meta in (False, True):
        cfg = dataclasses.replace(env, meta_pd=meta)
        step = K2.ControlStepSplit(topo, cfg, model, 2)
        act = 0.02 * torch.randn((8, step.act_dim), generator=gen)
        ins = [x.contiguous() for x in (qpos, qvel, act, tb)]
        _, _, X = _host_head(host, step, [x.numpy() for x in ins])
        h32, h64 = C.head_references(topo, cfg, model, ins)
        fails = []
        e = C.x_check(f"host K2 {family} meta={meta}", torch.from_numpy(X),
                      h32[2], h64[2], fails)
        assert not fails, (fails, e)
        assert np.all(np.isfinite(X))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_big_builds_keep_the_parent_arithmetic(trees, family):
    """Every entry of the host build on each big tree gives the outputs of
    the source as it was before the inverses moved to shared memory, bit
    for bit (digests): the packed in-place Cholesky, column-parallel
    inverse and Yᵀ Y, the packed preconditioner product and the column
    reads of A keep every sum's operands and order."""
    import chip_smoke as C
    from uhc_tpu_torch.physics import control_step as CS

    topo, env, model, lib = trees[family]
    host = _host(topo.nbody)
    gen = torch.Generator().manual_seed(5)
    qpos, qvel, tb = C.draw_big_states(lib, topo.nv, N_DIGEST, gen, "cpu")
    got = {}
    n, nv = N_DIGEST, topo.nv
    for meta in (False, True):
        cfg = dataclasses.replace(env, meta_pd=meta)
        step = CS.ControlStep(topo, cfg, model, (2, 2))
        act = 0.02 * torch.randn((n, step.act_dim), generator=gen)
        ins = [x.contiguous().numpy() for x in (qpos, qvel, act, tb)]
        tabs = [step.params.ctypes.data, None, step.itab.ctypes.data]
        dims = (n, step.act_dim, 1.0)
        key = f"{family}_meta{int(meta)}"
        q1, v1 = np.zeros_like(ins[0]), np.zeros_like(ins[1])
        assert host.uhc_control_step_host(*tabs, *_ptrs(*ins, q1, v1),
                                          *dims) == 0
        got[f"{key}_k1d"] = _digest(q1, v1)
        qm, vm, X = _host_head(host, step, ins)
        qo, vo = np.zeros_like(ins[0]), np.zeros_like(ins[1])
        assert host.uhc_control_step_tail_host(
            *tabs, *_ptrs(qm, vm, ins[2], ins[3], qo, vo, X), *dims) == 0
        got[f"{key}_head"] = _digest(qm, vm, X)
        got[f"{key}_tail"] = _digest(qo, vo)
        Xb = np.zeros((n, 2, nv, nv), np.uint16)
        assert host.uhc_control_step_head_bf16_host(
            *tabs, *_ptrs(*ins, qm, vm, Xb), *dims) == 0
        assert host.uhc_control_step_tail_bf16_host(
            *tabs, *_ptrs(qm, vm, ins[2], ins[3], qo, vo, Xb), *dims) == 0
        got[f"{key}_k2b"] = _digest(qm, vm, Xb, qo, vo)
        assert host.uhc_control_step_bf16_host(*tabs, *_ptrs(*ins, q1, v1),
                                               *dims) == 0
        got[f"{key}_k2b_one"] = _digest(q1, v1)
        k1g = CS.ControlStep(topo, cfg, model, (2, 2), refresh_at=8)
        assert host.uhc_control_step_host(
            k1g.params.ctypes.data, None, k1g.itab.ctypes.data,
            *_ptrs(*ins, q1, v1), *dims) == 0
        got[f"{key}_k1g"] = _digest(q1, v1)
    if family != "smplx":
        for mode in ("explicit", "meta_joint"):
            cfg = C.on_tree(C.k1f_modes()[mode], family)
            step = CS.ControlStep(topo, cfg, model, (2, 2))
            ins = C.k1f_draw(topo, cfg, lib, n, gen, "cpu")
            ops = [None if x is None else x.contiguous().numpy()
                   for x in CS.k1f_operands(topo, cfg, model, ins[2])]
            ins = [x.contiguous().numpy() for x in ins]
            q1, v1 = np.zeros_like(ins[0]), np.zeros_like(ins[1])
            assert host.uhc_control_step_f_host(
                step.params.ctypes.data, None, step.itab.ctypes.data,
                *_ptrs(*ins, q1, v1, *ops), n, step.act_dim, 1.0) == 0
            got[f"{family}_{mode}_k1f"] = _digest(q1, v1)
    want = {k: v for k, v in PARENT_DIGESTS.items()
            if k.startswith(family + "_")}
    assert got == want


@pytest.mark.parametrize("nb", [24, *FAMILIES.values()])
def test_layout_fits_a_block(nb):
    """Each host build's layout: at 48, 52 and 55 bodies the K1 and K1f
    shared memory, now with Xp and Xf as packed triangles, under a block's
    232,448 bytes, and the device workspace without them (A_pd, A_fd, J6,
    G); at 24 bodies on the SMPL tree, with Xp and Xf packed and J6 and G
    stored by subtree (2 × 6 × 429 floats), K1 and K1f each twice in an
    SM's 233,472 bytes with the 1,024 the SM reserves a block."""
    from uhc_tpu_torch.csrc import build

    lib = _host(nb)
    lay = build.layout(lib)
    if nb == 24:
        from uhc_tpu_torch.physics.control_step import jacobian_tables
        from uhc_tpu_torch.physics.model import Topology
        from uhc_tpu_torch.smpl.constants import MUJOCO_PARENTS

        topo = Topology(24, tuple(MUJOCO_PARENTS.tolist()), ("",) * 24)
        jg = int(jacobian_tables(topo)[0][-1])
        assert jg == 6 * SMPL_PAIRS
        sm = build.smem_floats(lib, jg)
        assert (lay["workspace"], lay["threads"]) == (0, 512)
        assert sm["step"] - lay["smem_floats"] == 2 * jg
        assert 0 <= sm["k1f"] - lay["smem_floats_k1f"] - 2 * jg < 4
        # A_pd and A_fd in full, Xp and Xf packed
        assert lay["smem_floats"] > 2 * 75 * 75 + 75 * 76
        for k in ("step", "k1f"):
            assert 2 * (4 * sm[k] + BLOCK_RESERVED) <= SM_BYTES, (k, sm)
        return
    nv = 6 + 3 * (nb - 1)
    assert lay["nbody"] == nb
    assert lay["workspace"] == 2 * nv * nv + 2 * nb * 6 * nv
    assert lay["smem_floats"] > nv * (nv + 1)      # both packed triangles
    assert 4 * lay["smem_floats"] < 4 * lay["smem_floats_k1f"] < SMEM_BYTES

