"""The harness end to end on the CPU at a tiny size: a sound run comes out
correct; with each fault a cell can have planted in the program
underneath, `correct` comes out false; nothing the run loads is JAX or
the JAX package, and the reference and the counts import nothing of the
program."""
import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run, session, spec
from benchmark.tests.tiny import TINY_LIMITS, tiny_bench, tiny_here


def _tiny_result(tmp_path, seed=2**31 + 7):
    here = tiny_here(tmp_path, limits=TINY_LIMITS)
    cell = spec.cell("tiny", tiny_bench(), here)
    ranks = [session.run_rank(None, cell, seed, 0.5, False, time.time(),
                              "cpu")]
    return run.result(cell, ranks, False, "cpu", 1)


def test_sound_run_is_correct(tmp_path):
    out = _tiny_result(tmp_path)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 24 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    assert [r[0] for r in out["checks"]][-1] == "ppo_change_gap"


def _unchanged_step(*a, **k):
    # the control step returns the state it was given
    return a[3], a[4]


def _last_env_unchanged(orig):
    # the control step leaves the last env's state as it was given (a
    # block of envs the kernel did not write)
    def step(*a, **k):
        qpos, qvel = orig(*a, **k)
        qpos, qvel = qpos.clone(), qvel.clone()
        qpos[-1:], qvel[-1:] = a[3][-1:], a[4][-1:]
        return qpos, qvel
    return step


FAULTS = {
    "step_unchanged": ("uhc_tpu_torch.physics.solver", "do_simulation",
                       lambda orig: _unchanged_step),
    "last_env_unchanged": ("uhc_tpu_torch.physics.solver", "do_simulation",
                           _last_env_unchanged),
    # the program's policy loss not finite (Python's max drops a NaN)
    "loss_nan": ("benchmark.check", "_surrogate",
                 lambda orig: lambda *a: torch.tensor(float("nan"))),
    "half_batch": ("uhc_tpu_torch.learn.ppo", "minibatches",
                   lambda orig: lambda N, mb, perm: [
                       i[:len(i) // 2] for i in orig(N, mb, perm)]),
    "optimizer_unchanged": ("torch.optim.Adam", "step",
                            lambda orig: lambda self, closure=None: None),
    "reward_altered": ("uhc_tpu_torch.rewards.reward_function",
                       "get_reward_fn", lambda orig: lambda rid: _altered(
                           orig(rid))),
}


def _altered(fn):
    def reward(*a, **k):
        r, terms = fn(*a, **k)
        return torch.cat([r[:1] * 1.01, r[1:]]), terms
    return reward


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_correct_false(tmp_path, monkeypatch, fault):
    import importlib

    modname, attr, make = FAULTS[fault]
    if modname == "torch.optim.Adam":
        target = torch.optim.Adam
    else:
        target = importlib.import_module(modname)
    monkeypatch.setattr(target, attr, make(getattr(target, attr)))
    out = _tiny_result(tmp_path)
    assert not out["correct"], out["checks"]


def test_a_nan_on_another_rank_fails(tmp_path):
    """A number that is NaN on the second rank only makes the merged run
    not correct."""
    here = tiny_here(tmp_path, limits=TINY_LIMITS)
    cell = spec.cell("tiny", tiny_bench(), here)
    r0 = session.run_rank(None, cell, 11, 0.2, False, time.time(), "cpu")
    assert run.result(cell, [r0], False, "cpu", 1)["correct"]
    r1 = {**r0, "numbers": {**r0["numbers"], "ppo_loss_gap": float("nan")}}
    out = run.result(cell, [r0, r1], False, "cpu", 2)
    assert not out["correct"], out["checks"]


def test_no_jax_after_a_dry_run(tmp_path):
    """A CPU dry run of the harness in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or uhc_tpu (compared whole)."""
    code = (
        "import json, sys, time\n"
        "from benchmark import run, session, spec\n"
        "from benchmark.tests.tiny import tiny_bench, tiny_here\n"
        f"here = tiny_here({str(tmp_path)!r})\n"
        "cell = spec.cell('tiny', tiny_bench(), here)\n"
        "r = session.run_rank(None, cell, 5, 0.2, True, time.time(), 'cpu')\n"
        "import benchmark.reference.frozen.smpl.fixture_humanoid\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "uhc_tpu_torch" in top and "benchmark" in top
    assert not top & set(session.FORBIDDEN), top & set(session.FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _files(*dirs):
    for d in dirs:
        for root, _, names in os.walk(os.path.join(spec.HERE, d)):
            yield from (os.path.join(root, n) for n in names
                        if n.endswith(".py"))


def test_reference_and_counts_import_nothing_of_the_program():
    for path in _files("reference", "counts"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("uhc_tpu_torch",) + session.FORBIDDEN, \
                (path, mod)


def test_benchmark_imports_no_jax():
    for path in _files("."):
        if os.sep + "tests" + os.sep in path:
            continue
        for mod in _imports(path):
            assert mod.split(".")[0] not in session.FORBIDDEN, (path, mod)


def _rank_without_exchange(dist, cell, seed, seconds):
    """A rank whose program leaves the gradients' exchange out (and its
    replica check, which would stop the run before the comparison)."""
    from uhc_tpu_torch.learn import data_parallel as DP
    from uhc_tpu_torch.learn.agent import CopycatAgent

    orig = DP.Dist.all_reduce
    DP.Dist.all_reduce = lambda self, t: (t if t.numel() > 100_000
                                          else orig(self, t))
    CopycatAgent._check_replicas = lambda self: None
    return session.run_rank(dist, cell, seed, seconds, False, time.time())


def _rank_sound(dist, cell, seed, seconds):
    return session.run_rank(dist, cell, seed, seconds, False, time.time())


def _rank_loads_jax(dist, cell, seed, seconds):
    """A rank whose check loads a module named `jax` once the window has
    closed (a stand-in module: the name is what is checked)."""
    import types

    from benchmark import check

    numbers = check.numbers

    def loading(*a, **k):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return numbers(*a, **k)

    check.numbers = loading
    return session.run_rank(dist, cell, seed, seconds, False, time.time())


@pytest.mark.parametrize("entry,want", [(_rank_sound, True),
                                        (_rank_without_exchange, False)])
def test_two_ranks(tmp_path, entry, want):
    """Two ranks over gloo on the CPU: a sound run is correct, one whose
    gradients are not exchanged is not."""
    from uhc_tpu_torch.learn import data_parallel

    here = tiny_here(tmp_path, ranks=2, limits=TINY_LIMITS)
    cell = spec.cell("tiny", tiny_bench(chips=2), here)
    ranks = data_parallel.spawn(entry, 2, "cpu", "gloo",
                                args=(cell, 2**33 + 1, 0.2), wait=900)
    out = run.result(cell, ranks, False, "cpu", 2)
    assert out["correct"] is want, out["checks"]


@pytest.mark.parametrize("entry,rc", [(_rank_sound, 0), (_rank_loads_jax, 3)])
def test_main_over_two_ranks(tmp_path, monkeypatch, capsys, entry, rc):
    """`run.main` past its look for cards, over two ranks on gloo: a sound
    run prints a correct result; a rank that loads `jax` after the window
    makes it exit non-zero, name the module and print no result."""
    from uhc_tpu_torch.learn import data_parallel

    here = tiny_here(tmp_path, ranks=2, limits=TINY_LIMITS)
    cell = spec.cell("tiny", tiny_bench(chips=2), here)
    monkeypatch.setattr(spec, "cell", lambda name: cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    monkeypatch.setattr(run, "run_cell", lambda c, seed, s, tr: (
        data_parallel.spawn(entry, 2, "cpu", "gloo", args=(c, seed, s),
                            wait=900)))
    got = run.main(["--workload", "tiny", "--seed", str(2**33 + 5),
                    "--seconds", "0.2", "--trace", "0"])
    cap = capsys.readouterr()
    assert got == rc, cap.err[-3000:]
    if rc:
        assert "jax" in cap.err and '"correct"' not in cap.out
    else:
        assert json.loads(cap.out.strip().splitlines()[-1])["correct"]
