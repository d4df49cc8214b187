"""The reader of `env_graph_replay_share` on made-up stats: the share of
the window's env-step calls that replayed a graph, rank 0's, and None
where the program counts neither replays nor eager calls."""
import pytest

from benchmark import spec


@pytest.mark.parametrize("epochs,want", [
    # 47 replays and 1 eager call an epoch
    ([{"count.env_graph.replay": 47, "count.env_graph.eager": 1}] * 2,
     100.0 * 47 / 48),
    # a first epoch with the capture: 46 replays, 1 eager, 1 capture
    ([{"count.env_graph.replay": 46, "count.env_graph.eager": 1,
       "count.env_graph.capture": 1},
      {"count.env_graph.replay": 48}], 100.0 * 94 / 95),
    ([{"count.env_graph.replay": 48}], 100.0),
    ([{"count.env_graph.eager": 48}], 0.0),
])
def test_replay_share(epochs, want):
    read = spec.reader("env_graph_replay_share")
    st = [{"T_total": 1.0, **e} for e in epochs]
    assert read({"ranks": [{"stats": st}]}) == pytest.approx(want)
    # rank 0's alone
    other = [{"T_total": 1.0, "count.env_graph.eager": 48}]
    assert read({"ranks": [{"stats": st}, {"stats": other}]}) == \
        pytest.approx(want)


def test_replay_share_of_a_program_without_the_counters():
    read = spec.reader("env_graph_replay_share")
    assert read({"ranks": [{"stats": [{"T_total": 1.0,
                                       "count.host_sync": 3}]}]}) is None
