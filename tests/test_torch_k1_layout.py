"""The 24-body control step's shared-memory layout, on the CPU: the CUDA
source built as host C++ at 24 bodies, where Xp and Xf are packed lower
triangles inverted in place in panels and J6 and G are stored by subtree
(body b's 6 rows hold only the dofs of its ancestors). Every entry's
outputs keep the digests of the source as it was before that layout (K1,
K1e, K1f, K2, K2 over a library, K2b, K1g), on seeded clip-frame draws of
the stand-in humanoid and on a 24-body tree of another depth; and
`pack_tables`' subtree offsets equal a count from the topology."""
import dataclasses
import hashlib
import shutil

import numpy as np
import pytest
import torch

from test_torch_helpers import GAIT, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

N = 8
# the SMPL tree with the left arm hung under the head and the right arm
# under the left hand: depth 15 instead of 8, still depth-first
DEEP_PARENTS = (-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14, 15,
                16, 17, 18, 19, 20, 21, 22)
# sha256 (first 16 hex digits) of the host build's outputs as the source
# was before Xp, Xf were packed and J6, G stored by subtree at 24 bodies
PARENT_DIGESTS = {
    "k1_plain_pd": "49544fb4856a1de6",
    "k1_meta_pd": "c27915ea1bc94a05",
    "k1e_shape_plain_pd": "8679bf3df0697203",
    "k1e_shape_meta_pd": "2641a74d32cb4bcf",
    "k1e_dr_plain_pd": "c4756355a11dce2e",
    "k1e_dr_meta_pd": "4fc365d51e7b68d2",
    "k2_head_plain_pd": "d2926121801b9e3a",
    "k2_tail_plain_pd": "8e6b79201eb5e05e",
    "k2_head_meta_pd": "1a2cee44b84561d7",
    "k2_tail_meta_pd": "a14657f6e1483719",
    "k2e_head_plain_pd": "fc009fe88ee8be57",
    "k2e_tail_plain_pd": "197380c56ea71cca",
    "k2e_head_meta_pd": "cfa2e6dcd7fbfe40",
    "k2e_tail_meta_pd": "0f709fe1479287ad",
    "k2b_head_plain_pd": "92baa7c69cf66287",
    "k2b_x_plain_pd": "cdd4ca080635ed28",
    "k2b_tail_plain_pd": "8ff1857093811af1",
    "k2b_one_plain_pd": "8ff1857093811af1",
    "k2b_head_meta_pd": "44242410b8520027",
    "k2b_x_meta_pd": "5b03d52a42044e25",
    "k2b_tail_meta_pd": "2a59868ef13b5061",
    "k2b_one_meta_pd": "2a59868ef13b5061",
    "k1g_plain_pd": "be3514d74727276b",
    "k1g_meta_pd": "994df8dc146c3a34",
    "k1f_explicit": "09cd45b8f4c0f4d8",
    "k1f_explicit_height": "a43ec33009a9b926",
    "k1f_explicit_ground": "ec755113237163fc",
    "k1f_meta_joint": "11c1890ca766f768",
    "k1f_explicit_meta_joint": "ef45f6a483a9f7e7",
    "k1f_meta_joint_shape": "3a937a4248a8f659",
    "deep_k1_plain_pd": "65818bbe78523fb9",
    "deep_k1_meta_pd": "1ea23c779bc6ecc7",
    "deep_k2_head_plain_pd": "3ebb62606616fa98",
    "deep_k2_tail_plain_pd": "10b8da459339390a",
    "deep_k2_head_meta_pd": "65ab509f5b93da5f",
    "deep_k2_tail_meta_pd": "ea651b1fe48cea46",
}


def _host():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    from uhc_tpu_torch.csrc import build

    return build.load_host_library(24)


@pytest.fixture(scope="module")
def setup():
    """The stand-in humanoid on the CPU, its gait library, the shaped and
    the domain-randomized model libraries."""
    import chip_smoke as C
    from uhc_tpu_torch.data.dataset import (build_dr_library,
                                            build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    topo, model_np = load_fixture_humanoid()
    model = model_from_numpy(model_np, "cpu")
    clips = load_motion_file(GAIT)
    lib, _ = build_expert_library(topo, model, clips, max_len=60)
    slib, _, smodel = C.shaped_library(topo, model, max_len=30)
    dlib, _, dmodel = build_dr_library(topo, model, clips, 4, max_len=60)
    return {"topo": topo, "model": model, "lib": lib,
            "libraries": {"shape": (slib, smodel), "dr": (dlib, dmodel)}}


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _np(xs):
    return [None if x is None else np.ascontiguousarray(x.numpy())
            for x in xs]


def _ptr(a):
    return None if a is None else a.ctypes.data


def _run(host, step, ins, entry="", seq=None, X=None, ops=None):
    """One host-build launch of `step`'s tables: entry "" (K1, K1e, K1g),
    "_bf16" (K2b at split=False), "_head", "_tail" and their "_bf16"
    twins with the Xp/Xf buffer X, or "_f" (K1f) with its operands
    `ops` -> (qpos', qvel')."""
    qpos, qvel, act, tb = ins
    qo, vo = np.zeros_like(qpos), np.zeros_like(qvel)
    args = [_ptr(step.params), _ptr(seq), _ptr(step.itab),
            *map(_ptr, (qpos, qvel, act, tb, qo, vo))]
    if X is not None:
        args.append(_ptr(X))
    if ops is not None:
        args += [_ptr(x) for x in ops]
    fn = getattr(host, f"uhc_control_step{entry}_host")
    assert fn(*args, qpos.shape[0], act.shape[1], 1.0) == 0
    assert np.all(np.isfinite(qo)) and np.all(np.isfinite(vo))
    return qo, vo


def _draw(s, cfg_act_dim, gen, library=None):
    """Seeded clip-frame states (over `library`'s rows with seq_idx where
    given) and 0.02 actions, as numpy."""
    import chip_smoke as C

    if library is None:
        qpos, qvel, tb = C.draw_states(s["lib"], N, gen, "cpu")
        seq = None
    else:
        qpos, qvel, tb, seq = C.draw_lib_states(s["libraries"][library][0],
                                                N, gen, "cpu")
    act = 0.02 * torch.randn((N, cfg_act_dim), generator=gen)
    return _np((qpos, qvel, act, tb)), (None if seq is None
                                        else _np((seq,))[0])


def _modes():
    from uhc_tpu_torch.config.config import Config

    env = Config.uhc_implicit().env
    return {"plain_pd": env, "meta_pd": dataclasses.replace(env,
                                                            meta_pd=True)}


def _k1(host, s, topo, gen, key):
    """K1 at (1, 2) in both modes."""
    from uhc_tpu_torch.physics import control_step as CS

    out = {}
    for mode, cfg in _modes().items():
        step = CS.ControlStep(topo, cfg, s["model"], (1, 2))
        ins, _ = _draw(s, step.act_dim, gen)
        out[f"{key}_{mode}"] = _digest(*_run(host, step, ins))
    return out


def _k2(host, s, topo, gen, key, library=None):
    """K2's head (qpos, qvel, Xp/Xf) and tail at PCG-2 in both modes,
    over a model library where given."""
    from uhc_tpu_torch.physics import control_step_split as K2

    out = {}
    nv = topo.nv
    for mode, cfg in _modes().items():
        model = s["model"] if library is None else s["libraries"][library][1]
        step = K2.ControlStepSplit(topo, cfg, model, 2)
        ins, seq = _draw(s, step.act_dim, gen, library)
        X = np.zeros((N, 2, nv, nv), np.float32)
        qh, vh = _run(host, step, ins, "_head", seq, X)
        qt, vt = _run(host, step, [qh, vh, *ins[2:]], "_tail", seq, X)
        out[f"{key}_head_{mode}"] = _digest(qh, vh, X)
        out[f"{key}_tail_{mode}"] = _digest(qt, vt)
    return out


def _case_k1(host, s):
    return _k1(host, s, s["topo"], torch.Generator().manual_seed(60), "k1")


def _case_k1e(host, s):
    """K1e at (1, 2) over the shaped and the DR library."""
    from uhc_tpu_torch.physics import control_step as CS

    gen = torch.Generator().manual_seed(61)
    out = {}
    for lname, (_, lmodel) in s["libraries"].items():
        for mode, cfg in _modes().items():
            step = CS.ControlStep(s["topo"], cfg, lmodel, (1, 2))
            ins, seq = _draw(s, step.act_dim, gen, lname)
            out[f"k1e_{lname}_{mode}"] = _digest(*_run(host, step, ins,
                                                       seq=seq))
    return out


def _case_k2(host, s):
    gen = torch.Generator().manual_seed(62)
    return {**_k2(host, s, s["topo"], gen, "k2"),
            **_k2(host, s, s["topo"], gen, "k2e", "shape")}


def _case_k2b(host, s):
    """K2b: head (qpos, qvel), its bfloat16 Xp/Xf, tail, split=False."""
    from uhc_tpu_torch.physics import control_step as CS
    from uhc_tpu_torch.physics import control_step_split as K2

    gen = torch.Generator().manual_seed(63)
    out = {}
    nv = s["topo"].nv
    for mode, cfg in _modes().items():
        split = K2.ControlStepSplit(s["topo"], cfg, s["model"], 2,
                                    precond_bf16=True)
        one = CS.ControlStep(s["topo"], cfg, s["model"], (2, 2),
                             precond_bf16=True)
        ins, _ = _draw(s, split.act_dim, gen)
        X = np.zeros((N, 2, nv, nv), np.uint16)
        qh, vh = _run(host, split, ins, "_head_bf16", X=X)
        qt, vt = _run(host, split, [qh, vh, *ins[2:]], "_tail_bf16", X=X)
        out[f"k2b_head_{mode}"] = _digest(qh, vh)
        out[f"k2b_x_{mode}"] = _digest(X)
        out[f"k2b_tail_{mode}"] = _digest(qt, vt)
        out[f"k2b_one_{mode}"] = _digest(*_run(host, one, ins, "_bf16"))
    return out


def _case_k1g(host, s):
    """K1g: K1 at (1, 1) with refresh_at=8."""
    from uhc_tpu_torch.physics import control_step as CS

    gen = torch.Generator().manual_seed(64)
    out = {}
    for mode, cfg in _modes().items():
        step = CS.ControlStep(s["topo"], cfg, s["model"], (1, 1),
                              refresh_at=8)
        ins, _ = _draw(s, step.act_dim, gen)
        out[f"k1g_{mode}"] = _digest(*_run(host, step, ins))
    return out


def _case_k1f(host, s):
    """K1f at (1, 2) in its five modes (a share of the envs lowered), and
    per-joint meta-PD over the shaped library."""
    import chip_smoke as C
    from uhc_tpu_torch.physics import control_step as CS

    gen = torch.Generator().manual_seed(65)
    out = {}
    topo, model = s["topo"], s["model"]
    for mode, cfg in C.k1f_modes().items():
        step = CS.ControlStep(topo, cfg, model, (1, 2))
        ins = C.k1f_draw(topo, cfg, s["lib"], N, gen, "cpu")
        ops = _np(CS.k1f_operands(topo, cfg, model, ins[2]))
        out[f"k1f_{mode}"] = _digest(*_run(host, step, _np(ins), "_f",
                                           ops=ops))
    cfg = C.k1f_modes()["meta_joint"]
    step = CS.ControlStep(topo, cfg, s["libraries"]["shape"][1], (1, 2))
    ins, seq = _draw(s, step.act_dim, gen, "shape")
    ops = _np(CS.k1f_operands(topo, cfg, model, torch.from_numpy(ins[2])))
    out["k1f_meta_joint_shape"] = _digest(*_run(host, step, ins, "_f", seq,
                                                ops=ops))
    return out


def _case_deep(host, s):
    """K1 and K2 on the 24-body tree of DEEP_PARENTS: its J6 and G take
    more shared memory than the SMPL tree's."""
    topo = dataclasses.replace(s["topo"], parents=DEEP_PARENTS)
    gen = torch.Generator().manual_seed(66)
    return {**_k1(host, s, topo, gen, "deep_k1"),
            **_k2(host, s, topo, gen, "deep_k2")}


CASES = {"k1": _case_k1, "k1e": _case_k1e, "k2": _case_k2,
         "k2b": _case_k2b, "k1g": _case_k1g, "k1f": _case_k1f,
         "deep": _case_deep}


@pytest.mark.parametrize("case", list(CASES))
def test_24_body_entries_keep_the_parent_arithmetic(setup, case):
    """Every 24-body entry of the host build gives the outputs of the
    source as it was before the layout change, bit for bit (digests): the
    packed in-place inverse, the packed preconditioner product and the
    subtree storage of J6 and G keep every sum's operands and order."""
    got = CASES[case](_host(), setup)
    want = {k: v for k, v in PARENT_DIGESTS.items()
            if k.split("_")[0] == case or (case == "k2" and
                                           k.startswith("k2e_"))}
    assert got == want


def _counted(parents):
    """J6 / G by subtree counted from the topology's ancestor mask: (row
    offsets, each dof's column, pairs b·nv + j)."""
    from uhc_tpu_torch.physics.model import Topology

    nb = len(parents)
    topo = Topology(nb, tuple(parents), ("",) * nb)
    mask = topo.ancestor_mask() > 0
    rows = np.concatenate([[0], np.cumsum(np.repeat(mask.sum(1), 6))])
    # the column of dof j: the dofs above it in the row of its own body
    db = topo.dof_body()
    cols = np.array([mask[db[j], :j].sum() for j in range(mask.shape[1])])
    b, j = np.nonzero(mask)
    return rows, cols, b * mask.shape[1] + j


@pytest.mark.parametrize("tree", ["smpl", "deep"])
def test_pack_tables_subtree_offsets(setup, tree):
    """pack_tables' J6 / G layout (the int table's I_JROW, I_JCOL, I_NJP,
    I_JPAIR after the self-collision pairs) against a count from the
    ancestor mask: 429 (body, dof) pairs on the SMPL tree, 564 on
    DEEP_PARENTS; its total sizes the host build's shared memory."""
    from uhc_tpu_torch.csrc import build
    from uhc_tpu_torch.physics import control_step as CS

    topo = setup["topo"]
    if tree == "deep":
        topo = dataclasses.replace(topo, parents=DEEP_PARENTS)
    rows, cols, pairs = _counted(list(topo.parents))
    assert len(pairs) == {"smpl": 429, "deep": 564}[tree]
    step = CS.ControlStep(topo, _modes()["plain_pd"], setup["model"])
    nb, nv = topo.nbody, topo.nv
    # parents, subtree ends, levels, their starts and count, pairs
    it = step.itab[4 * nb + 2 + 1 + 2 * CS.MAXPAIR:]
    assert np.array_equal(it[:6 * nb + 1], rows)
    assert np.array_equal(it[6 * nb + 1:6 * nb + 1 + nv], cols)
    off = 6 * nb + 1 + nv
    assert it[off] == len(pairs)
    jp_max = CS.max_jacobian_pairs(nb)
    assert np.array_equal(it[off + 1:off + 1 + len(pairs)], pairs)
    assert not it[off + 1 + len(pairs):off + 1 + jp_max].any()
    assert it[off + 1 + jp_max:].size == 8           # the config entries
    assert step.jg_floats == rows[-1] == 6 * len(pairs)
    lib = _host()
    assert build.layout(lib)["itab"] == step.itab.size
    assert build.smem_floats(lib, step.jg_floats)["step"] == (
        build.layout(lib)["smem_floats"] + 2 * step.jg_floats)
