"""Fixed-length windows (uhc_tpu_torch.data.windows) against the JAX
package's: `WindowSampler` gives the same draws for the same seed (batch
draws and the full sweep), and `gather_windows` over the port's expert
library of the gait clips equals the JAX gather over the same arrays
exactly (an indexed read: tolerance 0)."""
import numpy as np
import pytest
import torch

from test_torch_helpers import GAIT, close, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


@pytest.mark.parametrize("lengths,window", [
    ([240, 240, 210, 30, 12], 32),
    ([5, 64, 64], 64),
    ([100, 7, 50, 33, 240, 240, 210], 8),
])
def test_sampler_draws_equal(lengths, window):
    from uhc_tpu.data.windows import WindowSampler as J
    from uhc_tpu_torch.data.windows import WindowSampler as T

    j, t = J(lengths, window, seed=11), T(lengths, window, seed=11)
    np.testing.assert_array_equal(j.valid, t.valid)
    for b in (1, 7, 64):
        (js, jst), (ts, tst) = j.sample(b), t.sample(b)
        np.testing.assert_array_equal(js, ts)
        np.testing.assert_array_equal(jst, tst)
        assert np.all(tst + window <= np.asarray(lengths)[ts])
    assert list(j.iter_all()) == list(t.iter_all())
    assert list(j.iter_all(3)) == list(t.iter_all(3))


def test_sampler_refuses_short_library():
    from uhc_tpu_torch.data.windows import WindowSampler

    with pytest.raises(ValueError):
        WindowSampler([3, 4], 5)


def test_gather_over_library(tmp_path):
    import jax.numpy as jnp

    from uhc_tpu.data.windows import gather_windows as jgather
    from uhc_tpu_torch.data.dataset import (build_expert_library,
                                            load_motion_file)
    from uhc_tpu_torch.data.windows import WindowSampler, gather_windows
    from uhc_tpu_torch.physics.model import model_from_numpy
    from uhc_tpu_torch.smpl.fixture_humanoid import load_fixture_humanoid

    topo, model = load_fixture_humanoid()
    lib, _ = build_expert_library(topo, model_from_numpy(model, "cpu"),
                                  load_motion_file(GAIT), max_len=40)
    keys = ["qpos", "qvel", "wbpos", "wbquat"]
    s = WindowSampler(lib["len"].numpy(), 16, seed=5)
    seq, start = s.sample(9)
    got = gather_windows(lib, keys, seq, start, 16)
    want = jgather({k: jnp.asarray(lib[k].numpy()) for k in keys}, keys,
                   seq, start, 16)
    for k in keys:
        assert got[k].shape == (9, 16) + tuple(lib[k].shape[2:])
        assert got[k].device == lib[k].device
        close(np.asarray(want[k]), got[k], 0.0)
    # tensors for the indices work the same
    again = gather_windows(lib, keys, torch.as_tensor(seq),
                           torch.as_tensor(start), 16)
    for k in keys:
        assert torch.equal(again[k], got[k])
