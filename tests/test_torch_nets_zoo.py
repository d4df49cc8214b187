"""The rest of the model zoo (uhc_tpu_torch.learn.nets: TCN, the
discriminator, the discrete policy and its categorical helpers, the LSTM
cell, ERD, CMLP, SimpleCNN, the ResNet features, MobileNet and the three
video nets) against the JAX package's functions: weights drawn by the JAX
init carried across with `<net>_from_numpy`, the same seeded numpy inputs
through both, and each module's tree written back with `<net>_to_numpy`
equal to the JAX tree and accepted by the JAX apply function.
Tolerances: 2e-5 absolute on the affine nets, 1e-4 relative to the output's
largest entry where convolutions sum hundreds to thousands of products."""
import numpy as np
import pytest
import torch

import jax

from test_torch_helpers import close, few_threads

pytestmark = pytest.mark.usefixtures(few_threads.__name__)


def to_np(tree):
    """A JAX tree with its arrays as numpy (other leaves unchanged)."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_np(v) for v in tree]
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


def same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_tree(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def rel_close(j, t, rel):
    j = np.asarray(j, np.float64)
    close(j, t, rel * max(np.abs(j).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _pair(jinit, from_np, to_np_fn, key, *args, **kw):
    """JAX params -> port module, and the module's tree equal to JAX's."""
    jp = to_np(jinit(jax.random.PRNGKey(key), *args))
    m = from_np(jp, device="cpu", **kw)
    same_tree(jp, to_np_fn(m))
    return jp, m


@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("causal", [False, True])
def test_tcn(kernel_size, causal):
    from uhc_tpu.learn import nets as J
    from uhc_tpu_torch.learn import nets as N

    jp, m = _pair(J.tcn_init, N.tcn_from_numpy, N.tcn_to_numpy, 1, 5,
                  (6, 6, 4), kernel_size)
    # three levels: dilations 1, 2, 4, so (k - 1)·d is odd at k=2, d=1
    x = np.random.default_rng(2).standard_normal((2, 5, 11)).astype(
        np.float32)
    want = J.tcn_apply(jp, x, causal)
    with torch.no_grad():
        got = m(_t(x), causal)
    close(want, got, 2e-6)
    # causal: no output depends on a later input
    if causal:
        x2 = x.copy()
        x2[..., 7:] += 1.0
        with torch.no_grad():
            got2 = m(_t(x2), True)
        close(got[..., :7], got2[..., :7], 0.0)


def test_discriminator_and_discrete_policy():
    from uhc_tpu.learn import nets as J
    from uhc_tpu_torch.learn import nets as N

    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 12)).astype(np.float32)
    jp, m = _pair(J.discriminator_init, N.discriminator_from_numpy,
                  N.discriminator_to_numpy, 4, 12, (16, 8))
    with torch.no_grad():
        close(J.discriminator_apply(jp, x, "relu"), m(_t(x)), 2e-6)
    jp, m = _pair(J.discriminator_init, N.discriminator_from_numpy,
                  N.discriminator_to_numpy, 4, 12, (16, 8), activation="tanh")
    with torch.no_grad():
        close(J.discriminator_apply(jp, x, "tanh"), m(_t(x)), 2e-6)

    jp, pol = _pair(J.policy_discrete_init, N.policy_discrete_from_numpy,
                    N.policy_discrete_to_numpy, 5, 12, 6, (16,))
    with torch.no_grad():
        logits = pol(_t(x))
    jl = J.policy_discrete_logits(jp, x)
    close(jl, logits, 2e-6)
    act = rng.integers(0, 6, 7)
    close(J.categorical_log_prob(jl, act),
          N.categorical_log_prob(logits, torch.from_numpy(act)), 2e-6)
    other = rng.standard_normal((7, 6)).astype(np.float32)
    close(J.categorical_kl(jl, other),
          N.categorical_kl(logits, _t(other)), 2e-6)
    # the sampler draws from the generator: the same seed, the same
    # actions; over many draws each action's share is its probability
    # (binomial sd ≤ 0.0035 at 20000 draws: 5 sd)
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    a1 = N.categorical_sample(g(), logits)
    assert torch.equal(a1, N.categorical_sample(g(), logits))
    big = logits[:1].expand(20000, 6)
    draws = N.categorical_sample(g(), big)
    share = torch.bincount(draws, minlength=6).double() / 20000
    close(torch.softmax(logits[0].double(), -1).numpy(), share, 0.0175)


def test_lstm_erd_cmlp():
    from uhc_tpu.learn import nets as J
    from uhc_tpu_torch.learn import nets as N

    rng = np.random.default_rng(6)
    jp, m = _pair(J.lstm_init, N.lstm_from_numpy, N.lstm_to_numpy, 7, 5, 9)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    h = rng.standard_normal((4, 9)).astype(np.float32)
    c = rng.standard_normal((4, 9)).astype(np.float32)
    jo, (jh, jc) = J.lstm_apply(jp, x, (h, c))
    with torch.no_grad():
        to, (th, tc) = m(_t(x), (_t(h), _t(c)))
    close(jo, to, 2e-6)
    close(jc, tc, 2e-6)

    # ERD at its fixed 500 / 1000 widths, 6 steps of 3 envs, then 2
    # more steps carried on from the returned state
    jp, m = _pair(J.erd_init, N.erd_from_numpy, N.erd_to_numpy, 8, 10)
    xs = rng.standard_normal((6, 3, 10)).astype(np.float32)
    jy, js = J.erd_apply(jp, xs)
    with torch.no_grad():
        ty, ts = m(_t(xs))
    close(jy, ty, 2e-5)
    for a, b in zip(js, ts):
        close(a, b, 2e-5)
    xs2 = rng.standard_normal((2, 3, 10)).astype(np.float32)
    with torch.no_grad():
        close(J.erd_apply(jp, xs2, js)[0], m(_t(xs2), ts)[0], 2e-5)

    jp = to_np(J.cmlp_init(jax.random.PRNGKey(9), 7, 3, (16, 8)))
    cond = rng.standard_normal((5, 3)).astype(np.float32)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    for act in ("tanh", "relu", "sigmoid"):
        m = N.cmlp_from_numpy(jp, 3, act, device="cpu")
        same_tree(jp, N.cmlp_to_numpy(m))
        with torch.no_grad():
            close(J.cmlp_apply(jp, cond, x, act), m(_t(cond), _t(x)), 2e-6)


def test_simple_cnn():
    from uhc_tpu.learn import nets as J
    from uhc_tpu_torch.learn import nets as N

    jp, m = _pair(J.simple_cnn_init, N.simple_cnn_from_numpy,
                  N.simple_cnn_to_numpy, 10, 12)
    x = np.random.default_rng(11).standard_normal((2, 3, 224, 224)).astype(
        np.float32)
    with torch.no_grad():
        rel_close(J.simple_cnn_apply(jp, x), m(_t(x)), 1e-4)


@pytest.mark.parametrize("hw", [(33, 40), (40, 29)])
def test_resnet_feat(hw):
    """Odd and even sizes: the stride-4 stem is VALID, the 3×3 convs SAME."""
    from uhc_tpu.learn import nets as J
    from uhc_tpu_torch.learn import nets as N

    jp, m = _pair(J.resnet_feat_init, N.resnet_feat_from_numpy,
                  N.resnet_feat_to_numpy, 12, 10, 8, 2)
    x = np.random.default_rng(13).standard_normal((2, 3) + hw).astype(
        np.float32)
    with torch.no_grad():
        rel_close(J.resnet_feat_apply(jp, x), m(_t(x)), 1e-4)


@pytest.mark.parametrize("hw", [(37, 37), (32, 45)])
def test_mobile_net(hw):
    """"SAME" at stride 2 pads low total // 2, high the rest: an odd size
    puts the extra row / column at the high end."""
    from uhc_tpu.learn import nets as J
    from uhc_tpu_torch.learn import nets as N

    jp, m = _pair(J.mobile_net_init, N.mobile_net_from_numpy,
                  N.mobile_net_to_numpy, 14, 6)
    x = np.random.default_rng(15).standard_normal((2, 3) + hw).astype(
        np.float32)
    with torch.no_grad():
        rel_close(J.mobile_net_apply(jp, x), m(_t(x)), 1e-4)


def test_same_padding_rule():
    from uhc_tpu_torch.learn.nets import _same

    for n in range(1, 40):
        for k in (1, 3, 4):
            for s in (1, 2, 4):
                lo, hi = _same(n, k, s)
                out = -(-n // s)
                assert (n + lo + hi - k) // s + 1 == out
                assert lo == (lo + hi) // 2


@pytest.mark.parametrize("v_net_type", ["gru", "tcn"])
def test_video_state_and_reg_nets(v_net_type):
    from uhc_tpu.learn import nets as J
    from uhc_tpu_torch.learn import nets as N

    rng = np.random.default_rng(16)
    jp, m = _pair(J.video_state_net_init, N.video_state_net_from_numpy,
                  N.video_state_net_to_numpy, 17, 12, 10, v_net_type,
                  (8, 10))
    feats = rng.standard_normal((9, 12)).astype(np.float32)
    for causal in (False, True):
        with torch.no_grad():
            close(J.video_state_net_apply(jp, feats, causal),
                  m(_t(feats), causal), 2e-6)

    # mobile + GRU, resnet + TCN (v_hdim = the TCN's last width)
    cnn = "mobile" if v_net_type == "gru" else "resnet"
    jp, m = _pair(J.video_reg_net_init, N.video_reg_net_from_numpy,
                  N.video_reg_net_to_numpy, 18, 5, 10, 12, cnn, v_net_type,
                  (14, 9), (8, 10))
    frames = rng.standard_normal((4, 3, 35, 30)).astype(np.float32)
    with torch.no_grad():
        rel_close(J.video_reg_net_apply(jp, frames, True),
                  m(_t(frames), True), 1e-4)


@pytest.mark.parametrize("s_net_type", ["id", "gru"])
def test_video_forecast_net(s_net_type):
    from uhc_tpu.learn import nets as J
    from uhc_tpu_torch.learn import nets as N

    jp, m = _pair(J.video_forecast_net_init,
                  N.video_forecast_net_from_numpy,
                  N.video_forecast_net_to_numpy, 19, 12, 7, 10, 4,
                  s_net_type, 6 if s_net_type == "gru" else None)
    rng = np.random.default_rng(20)
    feats = rng.standard_normal((9, 12)).astype(np.float32)
    jv, js = J.video_forecast_initialize(jp, feats)
    with torch.no_grad():
        tv, ts = m.initialize(_t(feats))
        close(jv, tv, 2e-6)
        for _ in range(3):
            st = rng.standard_normal(7).astype(np.float32)
            jf, js = J.video_forecast_step(jp, jv, js, st)
            tf, ts = m(tv, ts, _t(st))
            close(jf, tf, 2e-6)
    assert tf.shape == (m.out_dim,)


def test_zoo_init_seeded():
    """zoo_init draws every leaf from the generator: one seed, one net;
    TCN convs small, biases zero there."""
    from uhc_tpu_torch.learn import nets as N

    def make(seed):
        return N.zoo_init(N.VideoRegNet(5, 10, 12, "resnet", "tcn", (14,),
                                        (8, 10)),
                          torch.Generator().manual_seed(seed), "cpu")

    a, b, c = make(1), make(1), make(2)
    ta, tb, tc = (N.video_reg_net_to_numpy(x) for x in (a, b, c))
    same_tree(ta, tb)
    assert not np.array_equal(ta["fc"]["w"], tc["fc"]["w"])
    conv = ta["v_net"]["net"][0]["conv1"]
    assert np.abs(conv["w"]).max() < 0.06 and not conv["b"].any()
    lim = 1.0 / np.sqrt(3 * 4 * 4)
    stem = ta["cnn"]["stem"]["w"]
    assert np.abs(stem).max() <= lim and np.abs(stem).max() > 0.5 * lim
