"""The env step's CUDA graph, off the card: the device-constant cache
(`utils/consts.py`), the signature a graph is keyed by
(`envs/step_graph.py`), the tracer's table set aside for a capture, and
the step itself, which runs its body eagerly on the CPU. The graph's
replays are checked on a card in tests/test_torch_step_graph_gpu.py."""
import dataclasses

import pytest
import torch

from uhc_tpu_torch.envs import humanoid_im as H
from uhc_tpu_torch.envs import step_graph as SG
from uhc_tpu_torch.maths import rotations as R
from uhc_tpu_torch.physics.model import Model
from uhc_tpu_torch.utils import consts, spans


def test_const_is_one_tensor_per_device_and_dtype():
    a32, b32 = torch.zeros(3), torch.ones(5)
    c = consts.const(R.CONJ_SIGNS, a32)
    assert consts.const(R.CONJ_SIGNS, b32) is c
    c64 = consts.const(R.CONJ_SIGNS, a32.double())
    assert c64 is not c and c64.dtype == torch.float64
    assert consts.const(R.CONJ_SIGNS, a32, torch.float64) is c64
    # the literals the call sites used before
    assert torch.equal(c, torch.tensor([1.0, -1.0, -1.0, -1.0]))
    assert torch.equal(consts.const(R.HEADING_MASK, a32),
                       torch.tensor([1.0, 0.0, 0.0, 1.0]))
    idx = consts.const((0, 4, 7), a32, torch.int64)
    assert idx.dtype == torch.int64 and idx.tolist() == [0, 4, 7]


def test_const_counts_its_one_copy():
    spans.begin()
    values = (0.125, -3.5, 7.0)     # a key no other code makes
    consts.const(values, torch.zeros(1))
    consts.const(values, torch.zeros(2))
    assert spans.table().get("count.host_sync") == 1


def test_rotations_give_the_old_results():
    q = torch.randn(64, 4, generator=torch.Generator().manual_seed(3))
    assert torch.equal(R.quat_conj(q),
                       q * q.new_tensor([1.0, -1.0, -1.0, -1.0]))
    assert torch.equal(R.heading_quat(q), R.quat_normalize(
        q * q.new_tensor([1.0, 0.0, 0.0, 1.0])))


def test_running_stats_row_count():
    from uhc_tpu_torch.learn import running_norm as RN

    x = torch.randn(7, 3, generator=torch.Generator().manual_seed(1))
    n, _, _ = RN._moments(x)
    assert n.dim() == 0 and n.dtype == x.dtype and n.item() == 7.0


def test_aside_sets_the_table_aside():
    spans.begin()
    with spans.span("rollout"):
        spans.count("obs")
        with spans.aside() as got:
            with spans.span("physics"):
                spans.count("obs", 2)
                spans.count("launch", 1)
        spans.count("obs")
    assert got == {"obs": 2, "launch": 1}
    t = spans.table()
    assert t["count.obs"] == 2 and "count.launch" not in t
    assert set(k for k in t if k.endswith(".n")) == {"rollout.n"}


def _inputs(B=4, obj=False, gen=None):
    """Made-up step inputs of the right kinds: (model, states, actions,
    expert_lib, jpos_diffw, body_diffw)."""
    gen = gen or torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.rand(shape, generator=gen)

    model = Model(**{f.name: r(3, 2) for f in dataclasses.fields(Model)})
    i64 = torch.zeros(B, dtype=torch.int64)
    false = torch.zeros(B, dtype=torch.bool)
    states = H.EnvState(qpos=r(B, 76), qvel=r(B, 75), prev_qpos=r(B, 76),
                        cur_t=i64, start_ind=i64.clone(),
                        seq_idx=i64.clone(), prev_bquat=r(B, 96),
                        done=false, fail=false.clone(), end=false.clone(),
                        percent=r(B), obj_qpos=r(B, 7) if obj else None)
    lib = {"qpos": r(2, 10, 76), "len": torch.tensor([10, 9])}
    return model, states, r(B, 114), lib, r(24), r(23)


def _key(model, states, actions, lib, jw, bw, rfc_rate=1.0, train=True,
         kernel=True):
    return SG.signature(model, states, actions, lib, jw, bw, rfc_rate,
                        train, kernel)


def test_signature_of_equal_inputs_is_equal():
    model, states, actions, lib, jw, bw = _inputs()
    # other tensors of the same shapes for what is copied in; the same
    # tensors for what is read in place
    _, states2, actions2, _, _, _ = _inputs(
        gen=torch.Generator().manual_seed(9))
    assert _key(model, states, actions, lib, jw, bw) == \
        _key(model, states2, actions2, lib, jw, bw)
    assert hash(_key(model, states, actions, lib, jw, bw)) == \
        hash(_key(model, states2, actions2, lib, jw, bw))
    # a new dict holding the same library tensors
    assert _key(model, states, actions, dict(lib), jw, bw) == \
        _key(model, states, actions, lib, jw, bw)


def _clone_model_leaf(model):
    return dataclasses.replace(model, jkp=model.jkp.clone())


@pytest.mark.parametrize("change", [
    "batch", "state_shape", "state_dtype", "action_shape", "rfc_rate",
    "train", "none_pattern", "kernel", "model_storage", "library_storage",
    "library_key", "jpos_diffw_storage", "body_diffw_storage"])
def test_signature_tells_apart(change):
    model, states, actions, lib, jw, bw = _inputs()
    base = _key(model, states, actions, lib, jw, bw)
    kw = {}
    if change == "batch":
        _, states, actions, _, _, _ = _inputs(B=8)
    if change == "state_shape":
        states = dataclasses.replace(states, prev_bquat=torch.zeros(4, 208))
    if change == "state_dtype":
        states = dataclasses.replace(states, percent=states.percent.double())
    if change == "action_shape":
        actions = torch.zeros(4, 105)
    if change == "rfc_rate":
        kw["rfc_rate"] = 0.5
    if change == "train":
        kw["train"] = False
    if change == "none_pattern":
        states = dataclasses.replace(states, obj_qpos=torch.zeros(4, 7))
    if change == "kernel":
        kw["kernel"] = False
    if change == "model_storage":
        model = _clone_model_leaf(model)
    if change == "library_storage":
        lib = {**lib, "qpos": lib["qpos"].clone()}
    if change == "library_key":
        lib = {**lib, "obj_pose": torch.zeros(2, 10, 7)}
    if change == "jpos_diffw_storage":
        jw = jw.clone()
    if change == "body_diffw_storage":
        bw = bw.clone()
    assert _key(model, states, actions, lib, jw, bw, **kw) != base


@pytest.fixture(scope="module")
def agent():
    """A 4-env copycat agent on the CPU (its model, library, weights and
    start states)."""
    import tempfile

    from uhc_tpu_torch.config.config import Config
    from uhc_tpu_torch.learn.agent import CopycatAgent

    with tempfile.TemporaryDirectory() as out:
        yield CopycatAgent(Config.uhc_implicit(), "sample_data/gait_clips.pkl",
                           num_envs=4, horizon=2, seed=3, max_seq_len=12,
                           results_dir=out, device="cpu")


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_env_step_on_the_cpu_runs_its_body(agent, route):
    """Off the card the step is its body, on the plain chain and on the
    kernel's route alike: the same numbers, and no graph counted."""
    from uhc_tpu_torch.physics.control_step import ControlStep

    a = agent
    step = H.make_env_step_batched(
        a.topo, a.env_cfg,
        fused_model=a.sim_model if route == "kernel" else None)
    assert isinstance(step.kernel, ControlStep) == (route == "kernel")
    assert step.capturable == (route == "kernel")
    st = dataclasses.replace(a.env_states,
                             done=torch.zeros_like(a.env_states.done))
    act = 0.01 * torch.randn(4, a.action_dim,
                             generator=torch.Generator().manual_seed(2))
    args = (a.sim_model, st, act, a.expert_lib, a.aux["jpos_diffw"],
            a.aux["body_diffw"])
    spans.begin()
    for _ in range(3):
        got = step(*args)
    assert not [k for k in spans.table() if "env_graph" in k]
    want = step.body(*args)
    for f in dataclasses.fields(st):
        x, y = getattr(got[0], f.name), getattr(want[0], f.name)
        assert (x is None and y is None) or torch.equal(x, y), f.name
    for x, y in zip(got[1:], want[1:]):
        assert torch.equal(x, y)
