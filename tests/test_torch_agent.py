"""The port's CopycatAgent and training CLI on the CPU: two epochs, the
value fit, checkpoints that both packages read, and the CLI's outputs."""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import GAIT, close, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of 4 envs × 4 steps on clips cut to 20 frames, with a
    minibatch of 8 rows (2 per pass)."""
    import dataclasses

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn.agent import CopycatAgent

    cfg = dataclasses.replace(Config.uhc_implicit(), mini_batch_size=8,
                              num_optim_epoch=2)
    agent = CopycatAgent(cfg, GAIT, num_envs=4, horizon=4, seed=3,
                         max_seq_len=20,
                         results_dir=str(tmp_path_factory.mktemp("run")),
                         device="cpu")
    stats = [agent.optimize_policy(i) for i in range(2)]
    return agent, stats


def test_two_epochs_give_finite_stats(trained):
    agent, stats = trained
    for st in stats:
        for k, v in st.items():
            assert np.all(np.isfinite(v)), (k, v)
        assert st["steps"] == 16
    assert agent.epoch == 1
    assert float(agent.rs.n) == 2 * 16
    # the log std follows the schedule (uhc_implicit: constant -2.3)
    assert torch.all(agent.log_std == -2.3)


def test_value_loss_falls_across_each_update(trained):
    _, stats = trained
    for st in stats:
        assert st["value_loss"] < st["value_loss_before"]


def _probe(dim, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (6, dim)).astype(np.float32)


def test_port_checkpoint_reads_in_jax(trained):
    """A checkpoint saved by the port, read with plain pickle, evaluated
    through uhc_tpu.learn.nets: policy mean and value equal the port's
    within 1e-5 (float32 products in another order)."""
    from uhc_tpu.learn import nets as JN

    agent, _ = trained
    path = agent.save_checkpoint(2)
    with open(path, "rb") as f:
        ck = pickle.load(f)
    assert set(ck) >= {"policy_params", "value_params", "log_std",
                       "running_stats", "sampler", "epoch"}
    x = _probe(agent.obs_dim)
    with torch.no_grad():
        mean_t = agent.policy(torch.tensor(x)).numpy()
        val_t = agent.value(torch.tensor(x)).numpy()
    close(JN.policy_mcp_mean(ck["policy_params"], jnp.asarray(x), "relu"),
          mean_t, 1e-5)
    close(JN.value_apply(ck["value_params"], jnp.asarray(x), "relu"), val_t,
          1e-5)
    np.testing.assert_array_equal(ck["log_std"], agent.log_std.numpy())
    assert float(ck["running_stats"]["n"]) == float(agent.rs.n)


def test_jax_checkpoint_loads_in_port(trained, tmp_path):
    """JAX-initialized params in a checkpoint of the JAX agent's layout,
    loaded by the port (also as a warm start): policy mean and value equal
    JAX's within 1e-5; the sampler and epoch follow the file unless warm
    starting."""
    from uhc_tpu.config.config import Config as JConfig
    from uhc_tpu.learn import nets as JN

    agent, _ = trained
    jcfg = JConfig()
    kp, kv = jax.random.split(jax.random.PRNGKey(7))
    pp, _ = JN.make_policy(jcfg, agent.obs_dim, agent.action_dim, kp)
    log_std = pp.pop("log_std")
    vp = JN.value_init(kv, agent.obs_dim, jcfg.value_hsize)
    rs = {"n": np.float32(40.0),
          "mean": np.linspace(-1, 1, agent.obs_dim).astype(np.float32),
          "m2": np.full(agent.obs_dim, 80.0, np.float32)}
    sampler = {"records": [[1.0, 0.0]] * 6, "fail_starts": [[3]] * 6}
    state = {"policy_params": jax.device_get(pp),
             "value_params": jax.device_get(vp),
             "log_std": np.asarray(log_std), "running_stats": rs,
             "sampler": sampler, "epoch": 9}
    path = tmp_path / "iter_0009.p"
    with open(path, "wb") as f:
        pickle.dump(state, f)
    agent.load_checkpoint_file(str(path), warm_start=True)
    assert agent.epoch == 1
    agent.load_checkpoint_file(str(path))
    assert agent.epoch == 9 and agent.sampler.state_dict() == sampler
    x = _probe(agent.obs_dim, 1)
    with torch.no_grad():
        close(JN.policy_mcp_mean(pp, jnp.asarray(x), "relu"),
              agent.policy(torch.tensor(x)), 1e-5)
        close(JN.value_apply(vp, jnp.asarray(x), "relu"),
              agent.value(torch.tensor(x)), 1e-5)
    np.testing.assert_array_equal(agent.rs.mean.numpy(), rs["mean"])
    # the reloaded nets train on: the optimizers hold the new parameters
    assert {id(p) for g in agent.policy_opt.param_groups
            for p in g["params"]} == {id(p) for p in
                                      agent.policy.parameters()}


def test_train_cli_writes_outputs(tmp_path):
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "uhc_tpu_torch.cli.train", "--device", "cpu",
         "--num-envs", "4", "--horizon", "4", "--epochs", "2",
         "--save-n-epochs", "2", "--max-seq-len", "8", "--results-dir",
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if " epoch " in ln]
    assert len(lines) == 2
    for key in ("R=", "succ=", "eps=", "len=", "sps=", "T="):
        assert key in lines[-1]
    rows = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [0, 1]
    assert os.path.isfile(out / "models" / "iter_0002.p")
    summary = json.load(open(out / "eval_0002.json"))
    assert summary["num_seqs"] == 6 and np.isfinite(summary["mpjpe"])


def test_train_cli_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from uhc_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--num-envs", "4", "--horizon", "4", "--epochs", "2",
                    "--results-dir", str(tmp_path)])
