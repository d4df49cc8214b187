"""The env step's CUDA graph on a card (marked gpu; run without
tests/conftest.py, which needs JAX: `python -m pytest --noconftest -m gpu
tests/test_torch_step_graph_gpu.py`).

At B=256 on the 24-body (K1) and the 52-body SMPL-H (K1d) trees: a
rollout of 2 x 48 steps with resets gives the same bits through the
graph's replays as through the eager body; what a step returned is not
written by the next; a change of rfc_rate, of the batch, of `train` or of
a library tensor runs eagerly or captures anew, never replays a graph
made for other inputs; a step keeps at most GRAPHS_KEPT graphs; and after
the capture a whole rollout step makes no host synchronization."""
import dataclasses
import tempfile

import pytest
import torch

from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.envs import step_graph as SG
from uhc_tpu_torch.learn import running_norm as RN
from uhc_tpu_torch.learn.rollout import init_env_states, reset_like
from uhc_tpu_torch.physics import control_step as CS
from uhc_tpu_torch.utils import spans

pytestmark = pytest.mark.gpu

B, HORIZON = 256, 48
GAIT = "sample_data/gait_clips.pkl"


@pytest.fixture(scope="module", params=["smpl", "smplh"])
def agent(request):
    """A copycat agent of B envs on the card, on the 24- or 52-body
    tree (its model, library, weights and policy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn.agent import CopycatAgent

    cfg = Config.uhc_implicit()
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, robot_model=request.param))
    with tempfile.TemporaryDirectory() as out:
        yield CopycatAgent(cfg, GAIT, num_envs=B, horizon=HORIZON, seed=5,
                           results_dir=out, device="cuda")


def _step(a):
    return H.make_env_step_batched(a.topo, a.env_cfg,
                                   fused_model=a.sim_model)


def _args(a, state, action, lib=None):
    return (a.sim_model, state, action,
            a.expert_lib if lib is None else lib, a.aux["jpos_diffw"],
            a.aux["body_diffw"])


@torch.no_grad()
def _rollout(a, step, steps, seed=11):
    """`steps` rollout steps as learn/rollout.py runs them (resets of
    finished episodes, the observation, the running statistics, the
    policy with noise) through `step`: every step's outputs as returned."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = init_env_states(a.topo, a.env_cfg, a.sim_model, a.expert_lib,
                            a.aux, gen, B)
    rs = RN.init(a.obs_dim, "cuda")
    logits = torch.zeros(len(a.seq_keys), device="cuda")
    outs = []
    for _ in range(steps):
        fresh = reset_like(a.topo, a.env_cfg, a.sim_model, a.expert_lib,
                           a.aux, B, gen, logits)
        state = H.state_where(state.done, fresh, state)
        obs = H.get_obs(a.topo, a.sim_model, a.env_cfg, state, a.expert_lib)
        rs = RN.update_batch(rs, obs)
        mean = a.policy(RN.normalize(rs, obs))
        action = mean + torch.exp(a.log_std) * torch.randn(
            mean.shape, generator=gen, device="cuda")
        outs.append(step(*_args(a, state, action), 1.0, True))
        state = outs[-1][0]
    return outs


def _flat(out):
    state, rest = out[0], out[1:]
    return [getattr(state, f.name) for f in dataclasses.fields(state)] + \
        list(rest)


def _same(x, y) -> bool:
    return all((p is None and q is None) or torch.equal(p, q)
               for p, q in zip(_flat(x), _flat(y)))


def test_graph_rollout_equals_the_eager_one(agent):
    """2 x 48 steps with resets: every step's state (qpos, qvel, ...),
    observation, reward, terms and done, bit for bit; one eager call, one
    capture, replays after; one kernel launch counted a replay."""
    step = _step(agent)
    spans.begin()
    CS.reset_launches()
    graph = _rollout(agent, step, 2 * HORIZON)
    torch.cuda.synchronize()
    counts = spans.table()
    launches = sum(CS.LAUNCHES.values())
    eager = _rollout(agent, step.body, 2 * HORIZON)
    assert counts["count.env_graph.eager"] == 1
    assert counts["count.env_graph.capture"] == 1
    assert counts["count.env_graph.replay"] == 2 * HORIZON - 2
    # the eager call, the capture's warm-up and one a replay
    assert launches == 2 * HORIZON + 1
    assert sum(int(o[-1].sum()) for o in eager) > 0, "no episode ended"
    for t, (g, e) in enumerate(zip(graph, eager)):
        assert _same(g, e), f"step {t}"


def test_a_step_does_not_write_what_the_last_returned(agent):
    step = _step(agent)
    outs = _rollout(agent, step, 3)
    kept = [None if x is None else x.clone() for x in _flat(outs[-1])]
    a = agent
    action = torch.zeros(B, a.action_dim, device="cuda")
    with torch.no_grad():
        step(*_args(a, outs[-1][0], action))
    for x, y in zip(_flat(outs[-1]), kept):
        assert (x is None and y is None) or torch.equal(x, y)


def _calls(step, a, state, action, n=1, lib=None, rfc_rate=1.0, train=True):
    """n calls of `step` on the same inputs, each checked against the eager
    body; the tracer's graph counters of the calls."""
    spans.begin()
    with torch.no_grad():
        want = step.body(*_args(a, state, action, lib), rfc_rate, train)
        for _ in range(n):
            got = step(*_args(a, state, action, lib), rfc_rate, train)
            assert _same(got, want)
    t = spans.table()
    return {k[len("count.env_graph."):]: v for k, v in t.items()
            if k.startswith("count.env_graph.")}, got


def test_new_inputs_never_replay_an_old_graph(agent):
    a = agent
    step = _step(a)
    state = _rollout(a, step.body, 2)[-1][0]
    act = 0.05 * torch.randn(B, a.action_dim, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(1))
    assert _calls(step, a, state, act, 3)[0] == \
        {"eager": 1, "capture": 1, "replay": 1}
    # rfc_rate, a launch argument of the kernel
    assert _calls(step, a, state, act, 1, rfc_rate=0.5)[0] == {"eager": 1}
    assert _calls(step, a, state, act, 2, rfc_rate=0.5)[0] == \
        {"capture": 1, "replay": 1}
    # half the batch
    half = type(state)(**{f.name: None if getattr(state, f.name) is None
                          else getattr(state, f.name)[:B // 2].contiguous()
                          for f in dataclasses.fields(state)})
    assert _calls(step, a, half, act[:B // 2].contiguous())[0] == \
        {"eager": 1}
    # evaluation's thresholds
    assert _calls(step, a, state, act, train=False)[0] == {"eager": 1}
    # a new library tensor, read in place: other numbers, run eagerly
    lib = {**a.expert_lib, "wbpos": a.expert_lib["wbpos"] + 0.05}
    counts, moved = _calls(step, a, state, act, lib=lib)
    assert counts == {"eager": 1}
    _, first = _calls(step, a, state, act)
    assert not torch.equal(moved[1], first[1])
    # the first inputs' graph is still there
    assert _calls(step, a, state, act)[0] == {"replay": 1}


def test_a_step_keeps_few_graphs(agent, monkeypatch):
    monkeypatch.setattr(SG, "GRAPHS_KEPT", 1)
    a = agent
    step = _step(a)
    state = _rollout(a, step.body, 2)[-1][0]
    act = torch.zeros(B, a.action_dim, device="cuda")
    assert _calls(step, a, state, act, 2)[0] == {"eager": 1, "capture": 1}
    assert _calls(step, a, state, act, 2, rfc_rate=0.5)[0] == \
        {"eager": 1, "capture": 1}
    assert len(step.graphs) == 1
    # the first graph went: its inputs are a first sighting again
    assert _calls(step, a, state, act)[0] == {"eager": 1}


def test_a_rollout_step_after_the_capture_never_waits(agent):
    step = _step(agent)
    a = agent
    gen = torch.Generator(device="cuda").manual_seed(3)
    state = init_env_states(a.topo, a.env_cfg, a.sim_model, a.expert_lib,
                            a.aux, gen, B)
    rs = RN.init(a.obs_dim, "cuda")
    logits = torch.zeros(len(a.seq_keys), device="cuda")

    def rollout_step(state, rs):
        fresh = reset_like(a.topo, a.env_cfg, a.sim_model, a.expert_lib,
                           a.aux, B, gen, logits)
        state = H.state_where(state.done, fresh, state)
        obs = H.get_obs(a.topo, a.sim_model, a.env_cfg, state, a.expert_lib)
        rs = RN.update_batch(rs, obs)
        mean = a.policy(RN.normalize(rs, obs))
        action = mean + torch.exp(a.log_std) * torch.randn(
            mean.shape, generator=gen, device="cuda")
        return step(*_args(a, state, action))[0], rs

    with torch.no_grad():
        for _ in range(3):
            state, rs = rollout_step(state, rs)
        torch.cuda.synchronize()
        assert len(step.graphs) == 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, rs = rollout_step(state, rs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
