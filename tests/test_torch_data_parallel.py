"""Data-parallel training's pieces on the CPU over gloo, two spawned ranks
(learn/data_parallel.py; the JAX mesh path's global-batch meaning): the
running statistics' merge, the global whitening and the PPO update, each
held against the single-process port on the concatenated batch, the PPO
update also against JAX `make_ppo_update`; the CLI's --data-parallel
rule and --profile. Each rank runs two torch threads; every spawn waits
at most SPAWN_S seconds."""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_dp_ranks as R
from test_torch_helpers import close, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

SPAWN_S = 240.0


@pytest.fixture(scope="module")
def pieces():
    """Both ranks' results of test_torch_dp_ranks.pieces_rank (one spawn)."""
    from uhc_tpu_torch.learn import data_parallel as DP

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        return DP.spawn(R.pieces_rank, 2, "cpu", "gloo", wait=SPAWN_S)


def test_a_run_outlasts_the_collective_timeout():
    """Rank 0 works 12 s with no collective while rank 1 waits in
    Dist.barrier, in a process group whose collectives time out after 8 s:
    the barrier holds no collective pending and the run's own limit
    (`wait`) is apart from the collectives', so both ranks return the
    sum."""
    from uhc_tpu_torch.learn import data_parallel as DP

    assert DP.spawn(R.slow_rank0, 2, "cpu", "gloo", args=(12.0,),
                    timeout=8.0, wait=SPAWN_S) == [2.0, 2.0]


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)
                        / np.maximum(np.abs(b), 1e-30)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("masked", [False, True])
def test_running_norm_merges_the_global_batch(pieces, masked, dtype):
    """Three batches merged over two ranks (masked: rank 1 holds no
    masked row in the second) equal update_batch over the concatenated
    batches: within 1e-12 relative in float64, 1e-6 in float32 (sums in
    another order); both ranks bit for bit alike."""
    from uhc_tpu_torch.learn import running_norm as RN

    np_dtype = np.dtype(dtype).type
    rs = R.rn_init(np_dtype)
    for xs, ms in R.rn_batches(masked, 2, np_dtype):
        rs = RN.update_batch(rs, torch.tensor(np.concatenate(xs)),
                             None if not masked else
                             torch.tensor(np.concatenate(ms)))
    want = RN.to_numpy(rs)
    got = [p["rn"][masked, dtype] for p in pieces]
    tol = 1e-12 if dtype == "float64" else 1e-6
    for k in ("n", "mean", "m2"):
        assert got[0][k].dtype == want[k].dtype
        assert _rel(got[0][k], want[k]) <= tol, k
        np.testing.assert_array_equal(got[0][k], got[1][k])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_whitening_takes_the_global_batch(pieces, dtype):
    """estimate_advantages on each rank's envs under dist equals it over
    the concatenated envs: within 1e-12 in float64, 1e-5 in float32 (the
    mean and std of 48 values summed in another order)."""
    from uhc_tpu_torch.learn.gae import estimate_advantages

    r, m, v, boot = R.gae_inputs(2, np.dtype(dtype).type)
    adv, ret = estimate_advantages(*(torch.tensor(x) for x in (r, m, v,
                                                               boot)),
                                   0.95, 0.95)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for rank, p in enumerate(pieces):
        a, b = p["gae"][dtype]
        cols = slice(rank * R.B, (rank + 1) * R.B)
        close(adv[:, cols], a, tol)
        close(ret[:, cols], b, tol)


def _owned_by_one(minibatch, passes):
    """Whether some minibatch of generator 0's permutations lies on one
    rank alone (the other rank then computes no loss term)."""
    from uhc_tpu_torch.learn.ppo import minibatches

    gen = torch.Generator().manual_seed(0)
    N, Bg = R.T * 2 * R.B, 2 * R.B
    for _ in range(passes):
        for idx in minibatches(N, minibatch, torch.randperm(N,
                                                            generator=gen)):
            if len(set(((idx % Bg) // R.B).tolist())) == 1:
                return True
    return False


@pytest.mark.parametrize("fix_std", [True, False],
                         ids=["fix_std", "trainable_std"])
def test_ppo_update_matches_single_process_f64(pieces, fix_std):
    """The 2-rank update in float64 (minibatches of 4 rows, 12 a pass, 3
    passes; some minibatch on one rank alone, the clip exercised) against
    ppo_update over the concatenated batch with the same permutations:
    params, log-std and losses within 1e-12 (float64 sums in another
    order, through 36 Adam steps); both ranks bit for bit alike."""
    name = f"f64_{'fix' if fix_std else 'trainable'}_std"
    _, mb, dtype = R.PPO_CASES[name]
    assert _owned_by_one(mb, R.PASSES)
    batch = {k: x.reshape(-1, *x.shape[2:])
             for k, x in R.ppo_batch(2, dtype).items()}
    pol, val, log_std, stats = R.ppo_run(batch, fix_std, mb, dtype)
    _clip_exercised(batch, dtype)
    got = [p["ppo"][name] for p in pieces]
    for a, b in zip(jax.tree.leaves((pol, val, log_std)),
                    jax.tree.leaves(got[0][:3])):
        close(a, b, 1e-12)
    for k, v in stats.items():
        close(v, got[0][3][k], 1e-12, 1e-12)
    for a, b in zip(jax.tree.leaves(got[0][:3]),
                    jax.tree.leaves(got[1][:3])):
        np.testing.assert_array_equal(a, b)
    assert got[0][3] == got[1][3]
    moved = np.abs(got[0][2] - np.float64(-2.3)).max()
    assert moved == 0.0 if fix_std else moved > 0.5 * R.LR_P


def _clip_exercised(batch, dtype):
    """The policy gradient's norm on the whole batch exceeds the clip."""
    from uhc_tpu_torch.learn import nets
    from uhc_tpu_torch.learn.ppo import policy_loss

    pol, _ = R.small_nets(R.torch_dtype(dtype))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    ls = torch.full((R.A,), -2.3, dtype=tb["states"].dtype)
    flp = nets.gaussian_log_prob(pol(tb["states"]), ls,
                                 tb["actions"]).detach()
    policy_loss(pol, ls, tb["states"], tb["actions"], tb["advantages"], flp,
                tb["exps"], 0.2).backward()
    assert torch.sqrt(sum((p.grad ** 2).sum()
                          for p in pol.parameters())) > 40.0


@pytest.mark.parametrize("fix_std", [True, False],
                         ids=["fix_std", "trainable_std"])
def test_ppo_update_matches_jax(pieces, fix_std):
    """The 2-rank update in float32, one minibatch of the whole 48-row
    batch a pass (so JAX's shuffle only reorders rows inside it), 3
    passes, against JAX make_ppo_update on the whole batch, at the bounds
    of tests/test_torch_train.py: params within 2·lr per Adam step, the
    log-std within 1e-2·lr per step, losses within 1e-5 relative (and
    1e-5 absolute with a trainable std, as there)."""
    import optax

    from uhc_tpu.learn import nets as JN
    from uhc_tpu.learn.ppo import PPOState, make_ppo_update
    from uhc_tpu_torch.learn import nets

    name = f"f32_{'fix' if fix_std else 'trainable'}_std"
    _, mb, dtype = R.PPO_CASES[name]
    batch = {k: x.reshape(-1, *x.shape[2:])
             for k, x in R.ppo_batch(2, dtype).items()}
    _clip_exercised(batch, dtype)
    pol, val = R.small_nets()
    pp, vp = nets.policy_to_numpy(pol), nets.value_to_numpy(val)
    log_std = np.full(R.A, -2.3, np.float32)
    popt, vopt = optax.adam(R.LR_P), optax.adam(R.LR_V)
    lopt = None if fix_std else optax.adam(R.LR_P)
    update = make_ppo_update(
        lambda p, x: JN.policy_mcp_mean(p, x, "relu"),
        lambda p, x: JN.value_apply(p, x, "relu"), popt, vopt, 0.2,
        R.PASSES, mb, fix_std=fix_std, log_std_optimizer=lopt)
    jstate, jlog_std, jstats = update(
        PPOState(pp, vp, popt.init(pp), vopt.init(vp),
                 None if fix_std else lopt.init(jnp.asarray(log_std))),
        jnp.asarray(log_std), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    tpol, tval, tlog_std, stats = pieces[0]["ppo"][name]
    for k in ("value_loss", "policy_loss"):
        close(jstats[k], stats[k], 0.0 if fix_std else 1e-5, 1e-5)
    for tree_j, tree_t, lr in ((jstate.policy_params, tpol, R.LR_P),
                               (jstate.value_params, tval, R.LR_V)):
        for a, b in zip(jax.tree.leaves(tree_j), jax.tree.leaves(tree_t)):
            close(a, b, 2 * lr * R.PASSES)
    close(jlog_std, tlog_std, 1e-2 * R.LR_P * R.PASSES)
    assert stats["value_loss"] < stats["value_loss_before"]


def test_cli_data_parallel_on_cpu_takes_the_single_process_path(tmp_path):
    """--data-parallel with --device cpu: one process, as the JAX CLI
    without more than one device, and the log says so."""
    from uhc_tpu_torch.cli import train

    agent, hist = train.main([
        "--device", "cpu", "--data-parallel", "--num-envs", "2",
        "--horizon", "2", "--epochs", "1", "--no-train-eval",
        "--max-seq-len", "8", "--results-dir", str(tmp_path)])
    assert agent is not None and agent.dist is None and len(hist) == 1
    log = (tmp_path / "log.txt").read_text()
    assert "--data-parallel: one device (cpu), the single-process path" \
        in log


def test_cli_data_parallel_refuses_uhm(tmp_path, capsys):
    """--agent uhm has no data-parallel path: the CLI refuses (the JAX CLI
    builds a mesh and never passes it on)."""
    from uhc_tpu_torch.cli import train

    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--agent", "uhm", "--cfg", "uhm_1",
                    "--data-parallel", "--results-dir", str(tmp_path)])
    assert e.value.code == 2
    assert "--data-parallel trains the copycat only" in \
        capsys.readouterr().err


def test_profile_traces_epochs_two_to_four(tmp_path):
    """--profile DIR over 5 epochs on the CPU: DIR/trace.json, a Chrome
    trace whose epoch spans are epochs 2, 3 and 4, with the CPU's
    operators inside."""
    from uhc_tpu_torch.cli import train

    prof = tmp_path / "prof"
    train.main(["--device", "cpu", "--num-envs", "1", "--horizon", "1",
                "--epochs", "5", "--no-train-eval", "--max-seq-len", "8",
                "--results-dir", str(tmp_path / "run"), "--profile",
                str(prof)])
    # ~10^5 events of the plain chain an epoch on the CPU: the names are
    # read from the text, not parsed into objects
    text = (prof / "trace.json").read_text()
    assert '"traceEvents"' in text
    assert set(re.findall(r'"name": "(epoch \d+)"', text)) == {
        "epoch 2", "epoch 3", "epoch 4"}
    assert '"name": "aten::' in text
    log = (tmp_path / "run" / "log.txt").read_text()
    assert f"profiler trace (epochs 2-4) -> {prof / 'trace.json'}" in log
