"""Policy and value networks (PyTorch twin of uhc_tpu.learn.nets: the MLP
trunk, the Gaussian policy mean, the multiplicative compositional (MCP)
policy mean, the transformer policy mean over per-body tokens, the value
head, the GRU cell of the kinematic policy and the diagonal Gaussian's
log-density and KL), and the rest of the model zoo: the temporal conv net,
the discriminator, the discrete policy and its categorical helpers, the
LSTM cell, ERD, the conditioned MLP, SimpleCNN, the ResNet-style feature
net, MobileNet and the three video nets.

Weights use the JAX package's (in, out) layout so a checkpoint's parameter
tree carries across unchanged: `policy_from_numpy` / `value_from_numpy`
take the nested dicts and lists of numpy arrays of a checkpoint pickle,
`policy_to_numpy` / `value_to_numpy` write them; every zoo net has its
`<net>_from_numpy` / `<net>_to_numpy` pair over the JAX init's tree.
Convolution kernels keep XLA's (out, in, k...) layout and padding: TCN's
"same" length pads (pad // 2, pad - pad // 2) (causal: (pad, 0)), and
"SAME" at a stride pads low total // 2 and high the rest.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu,
               "sigmoid": torch.sigmoid,
               "gelu": lambda x: nn.functional.gelu(x, approximate="tanh")}


class MLP(nn.Module):
    """Stack of activated affine layers; with a leading `stack` size, one
    independent MLP per stack entry applied to the same input."""

    def __init__(self, in_dim: int, hidden: Sequence[int], activation: str,
                 stack: int | None = None, final: tuple | None = None):
        super().__init__()
        self.activation = activation
        self.stack = stack
        dims = [in_dim] + list(hidden)
        lead = () if stack is None else (stack,)
        self.ws = nn.ParameterList(
            nn.Parameter(torch.zeros(lead + (a, b)))
            for a, b in zip(dims[:-1], dims[1:]))
        self.bs = nn.ParameterList(
            nn.Parameter(torch.zeros(lead + (b,))) for b in dims[1:])
        # optional un-activated output layer (policy / value heads)
        self.head_w = self.head_b = None
        if final is not None:
            self.head_w = nn.Parameter(torch.zeros(lead + (dims[-1],
                                                           final[0])))
            self.head_b = nn.Parameter(torch.zeros(lead + (final[0],)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        if self.stack is not None:
            x = x.expand((self.stack,) + x.shape)
        for w, b in zip(self.ws, self.bs):
            x = act(torch.matmul(x, w) + b.unsqueeze(-2)
                    if self.stack is not None else x @ w + b)
        if self.head_w is not None:
            if self.stack is not None:
                x = torch.matmul(x, self.head_w) + self.head_b.unsqueeze(-2)
            else:
                x = x @ self.head_w + self.head_b
        return x


class PolicyGaussian(nn.Module):
    """Trunk -> mean head (policy_gaussian_mean)."""

    def __init__(self, state_dim, action_dim, hidden, activation="relu"):
        super().__init__()
        self.net = MLP(state_dim, hidden, activation, final=(action_dim,))

    def forward(self, x):
        return self.net(x)


class PolicyMCP(nn.Module):
    """num_primitive trunk+head MLPs mixed by a softmax composer
    (policy_mcp_mean)."""

    def __init__(self, state_dim, action_dim, hidden, composer_hidden,
                 num_primitive, activation="relu"):
        super().__init__()
        self.prims = MLP(state_dim, hidden, activation, stack=num_primitive,
                         final=(action_dim,))
        self.composer = MLP(state_dim,
                            list(composer_hidden) + [num_primitive],
                            activation)

    def forward(self, x):
        means = self.prims(x)                                # (P, B, A)
        w = torch.softmax(self.composer(x), dim=-1)          # (B, P)
        return torch.einsum("bp,pba->ba", w, means)


class Value(nn.Module):
    """Trunk -> scalar head (value_apply)."""

    def __init__(self, state_dim, hidden, activation="relu"):
        super().__init__()
        self.net = MLP(state_dim, hidden, activation, final=(1,))

    def forward(self, x):
        return self.net(x)[..., 0]


def _pos_encoding(n: int, d: int) -> torch.Tensor:
    """Sinusoidal positions (n, d): sin on even columns, cos on odd,
    computed in float64 and rounded, as the JAX package does."""
    pos = np.arange(n)[:, None]
    i = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d)
    return torch.as_tensor(np.where(i % 2 == 0, np.sin(angle),
                                    np.cos(angle)).astype(np.float32))


def _affine(a: int, b: int) -> nn.ParameterDict:
    return nn.ParameterDict({"w": nn.Parameter(torch.zeros(a, b)),
                             "b": nn.Parameter(torch.zeros(b))})


def _ln(x, p):
    """Layer norm over the last axis: population variance, eps 1e-5."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]


class PolicyTransformer(nn.Module):
    """Pre-norm transformer encoder over per-body tokens
    (uhc_tpu.learn.nets policy_transformer_mean): the observation is a
    global block then n_tokens rows of token_dim (obs v4's local rows);
    each token is its row with the global block appended, embedded, given
    sinusoidal positions and run through `nlayers` attention + GELU MLP
    blocks. Per-token heads give 3 action dims each (the joints), a head
    on the mean token the rest (root, RFC, meta-PD). The attention is
    written out as the JAX function writes it."""

    def __init__(self, n_tokens, token_dim, global_dim, action_dim,
                 d_model=128, nhead=4, ff_dim=256, nlayers=2):
        super().__init__()
        self.n_tokens, self.token_dim = n_tokens, token_dim
        self.global_dim, self.d_model, self.nhead = global_dim, d_model, \
            nhead
        self.embed = _affine(token_dim + global_dim, d_model)
        self.layers = nn.ModuleList(nn.ModuleDict({
            "wqkv": _affine(d_model, 3 * d_model),
            "wo": _affine(d_model, d_model),
            "ff1": _affine(d_model, ff_dim),
            "ff2": _affine(ff_dim, d_model),
            "ln1": nn.ParameterDict({"g": nn.Parameter(torch.ones(d_model)),
                                     "b": nn.Parameter(torch.zeros(d_model))}),
            "ln2": nn.ParameterDict({"g": nn.Parameter(torch.ones(d_model)),
                                     "b": nn.Parameter(torch.zeros(d_model))}),
        }) for _ in range(nlayers))
        self.head_tok = _affine(d_model, 3)
        self.head_glob = _affine(d_model, action_dim - 3 * n_tokens)
        self.register_buffer("pos", _pos_encoding(n_tokens, d_model),
                             persistent=False)

    def forward(self, obs):
        B = obs.shape[0]
        nt, td, gd = self.n_tokens, self.token_dim, self.global_dim
        d, nh = self.d_model, self.nhead
        hd = d // nh
        g = obs[:, :gd]
        x = torch.cat([obs[:, gd:].reshape(B, nt, td),
                       g[:, None, :].expand(B, nt, gd)], -1)
        h = x @ self.embed["w"] + self.embed["b"] + self.pos
        for lp in self.layers:
            qkv = _ln(h, lp["ln1"]) @ lp["wqkv"]["w"] + lp["wqkv"]["b"]
            q, k, v = (t.reshape(B, nt, nh, hd).transpose(1, 2)
                       for t in qkv.split(d, -1))
            att = torch.softmax(q @ k.transpose(2, 3) / np.sqrt(hd), -1)
            o = (att @ v).transpose(1, 2).reshape(B, nt, d)
            h = h + o @ lp["wo"]["w"] + lp["wo"]["b"]
            hn = _ln(h, lp["ln2"])
            h = h + nn.functional.gelu(
                hn @ lp["ff1"]["w"] + lp["ff1"]["b"], approximate="tanh") \
                @ lp["ff2"]["w"] + lp["ff2"]["b"]
        per_tok = (h @ self.head_tok["w"] + self.head_tok["b"]).reshape(
            B, 3 * nt)
        rest = h.mean(1) @ self.head_glob["w"] + self.head_glob["b"]
        return torch.cat([per_tok, rest], -1)


def _set(p: nn.Parameter, v) -> None:
    v = torch.from_numpy(np.array(v, np.float32))
    if tuple(v.shape) != tuple(p.shape):
        raise ValueError(f"shape {tuple(v.shape)} != {tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(v)


def _load_trunk(mlp: MLP, layers, head=None) -> None:
    for w, b, layer in zip(mlp.ws, mlp.bs, layers):
        _set(w, layer["w"])
        _set(b, layer["b"])
    if head is not None:
        _set(mlp.head_w, head["w"])
        _set(mlp.head_b, head["b"])


def _load_tree(module: nn.Module, tree) -> None:
    """Copy a nested dict / list of arrays onto the module's parameters
    of the same names."""
    if isinstance(module, nn.Parameter):
        _set(module, tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _load_tree(module[k] if isinstance(
                module, (nn.ModuleDict, nn.ParameterDict))
                else getattr(module, k), v)
    else:
        for m, v in zip(module, tree):
            _load_tree(m, v)


def policy_from_numpy(params, activation: str = "relu",
                      device="cuda", n_tokens: int | None = None,
                      token_dim: int | None = None,
                      nhead: int = 4) -> nn.Module:
    """JAX policy parameter tree (nested dicts/lists of numpy arrays) ->
    PolicyMCP, PolicyGaussian or PolicyTransformer module on `device`.
    A transformer tree needs its token layout (`n_tokens`, `token_dim`)
    and head count, which the JAX package keeps beside the tree."""
    if "embed" in params:
        if n_tokens is None or token_dim is None:
            raise ValueError("a transformer policy needs n_tokens and "
                             "token_dim")
        tok_in, d_model = np.shape(params["embed"]["w"])
        m = PolicyTransformer(
            n_tokens, token_dim, tok_in - token_dim,
            3 * n_tokens + np.shape(params["head_glob"]["w"])[1], d_model,
            nhead, np.shape(params["layers"][0]["ff1"]["w"])[1],
            len(params["layers"]))
        _load_tree(m, {k: v for k, v in params.items() if k != "log_std"})
        return m.to(device).eval()
    if "prims" in params:
        trunk = params["prims"]["trunk"]
        P, D = np.shape(trunk[0]["w"])[:2]
        hidden = [np.shape(t["w"])[-1] for t in trunk]
        A = np.shape(params["prims"]["head"]["w"])[-1]
        comp = params["composer"]["trunk"]
        m = PolicyMCP(D, A, hidden, [np.shape(t["w"])[-1] for t in comp[:-1]],
                      P, activation)
        _load_trunk(m.prims, trunk, params["prims"]["head"])
        _load_trunk(m.composer, comp)
    else:
        trunk = params["trunk"]
        D = np.shape(trunk[0]["w"])[0]
        m = PolicyGaussian(D, np.shape(params["mean"]["w"])[-1],
                           [np.shape(t["w"])[-1] for t in trunk], activation)
        _load_trunk(m.net, trunk, params["mean"])
    return m.to(device).eval()


def stack_policies(policies: Sequence[nn.Module]):
    """S policies of one architecture -> fn(x (S, D)) -> (S, A) that runs
    row s through policy s: the weights stacked on a leading axis and one
    forward vmapped over it (a batched matmul per layer, not S forwards;
    uhc_tpu.learn.evaluate's per_seq_params)."""
    from torch.func import functional_call, stack_module_state, vmap

    params, buffers = stack_module_state(list(policies))
    base = copy.deepcopy(policies[0]).to("meta")

    def one(p, b, x):
        return functional_call(base, (p, b), (x[None],))[0]

    batched = vmap(one)
    return lambda x: batched(params, buffers, x)


def value_from_numpy(params, activation: str = "relu",
                     device="cuda") -> nn.Module:
    trunk = params["trunk"]
    m = Value(np.shape(trunk[0]["w"])[0],
              [np.shape(t["w"])[-1] for t in trunk], activation)
    _load_trunk(m.net, trunk, params["head"])
    return m.to(device).eval()


def _dump_trunk(mlp: MLP, head: bool):
    def arr(p):
        return p.detach().cpu().numpy().copy()

    layers = [{"w": arr(w), "b": arr(b)} for w, b in zip(mlp.ws, mlp.bs)]
    return layers, ({"w": arr(mlp.head_w), "b": arr(mlp.head_b)}
                    if head else None)


def _dump_tree(module):
    if isinstance(module, nn.Parameter):
        return module.detach().cpu().numpy().copy()
    if isinstance(module, (nn.ModuleDict, nn.ParameterDict)):
        return {k: _dump_tree(v) for k, v in module.items()}
    return [_dump_tree(v) for v in module]


def policy_to_numpy(m: nn.Module) -> dict:
    """PolicyMCP / PolicyGaussian / PolicyTransformer -> the JAX parameter
    tree (numpy)."""
    if isinstance(m, PolicyTransformer):
        return {k: _dump_tree(getattr(m, k))
                for k in ("embed", "layers", "head_tok", "head_glob")}
    if isinstance(m, PolicyMCP):
        trunk, head = _dump_trunk(m.prims, True)
        return {"prims": {"trunk": trunk, "head": head},
                "composer": {"trunk": _dump_trunk(m.composer, False)[0]}}
    trunk, head = _dump_trunk(m.net, True)
    return {"trunk": trunk, "mean": head}


def value_to_numpy(m: Value) -> dict:
    trunk, head = _dump_trunk(m.net, True)
    return {"trunk": trunk, "head": head}


def gaussian_log_prob(mean, log_std, action):
    """Diagonal Gaussian log-density, summed over the action axis."""
    var = torch.exp(2.0 * log_std)
    lp = -((action - mean) ** 2) / (2 * var) - 0.5 * np.log(2 * np.pi) \
        - log_std
    return lp.sum(-1)


def gaussian_kl(mean0, log_std0, mean1, log_std1):
    """KL(N(mean0, std0) ‖ N(mean1, std1)) of diagonal Gaussians, summed
    over the action axis."""
    var0 = torch.exp(2.0 * log_std0)
    var1 = torch.exp(2.0 * log_std1)
    kl = (log_std1 - log_std0
          + (var0 + (mean0 - mean1) ** 2) / (2.0 * var1) - 0.5)
    return kl.sum(-1)


class GRU(nn.Module):
    """One GRU cell step in torch nn.GRUCell's gate order (reset, update,
    new) with the JAX package's (in, 3H) weights (uhc_tpu.learn.nets
    gru_apply): r = σ(x W_ir + b_ir + h W_hr + b_hr), z likewise,
    n = tanh(x W_in + b_in + r ⊙ (h W_hn + b_hn)), h' = (1 - z) n + z h."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_ih = nn.Parameter(torch.zeros(in_dim, 3 * hidden))
        self.w_hh = nn.Parameter(torch.zeros(hidden, 3 * hidden))
        self.b_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.b_hh = nn.Parameter(torch.zeros(3 * hidden))

    def forward(self, x, h):
        H = self.hidden
        gi = x @ self.w_ih + self.b_ih
        gh = h @ self.w_hh + self.b_hh
        r = torch.sigmoid(gi[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
        return (1.0 - z) * n + z * h


GRU_LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh")


def gru_from_numpy(params, device="cuda") -> GRU:
    """A checkpoint's GRU leaves {w_ih (in, 3H), w_hh (H, 3H), b_ih, b_hh}
    -> GRU on `device`."""
    in_dim, h3 = np.shape(params["w_ih"])
    m = GRU(in_dim, h3 // 3)
    for k in GRU_LEAVES:
        _set(getattr(m, k), params[k])
    return m.to(device)


def gru_to_numpy(m: GRU) -> dict:
    return {k: getattr(m, k).detach().cpu().numpy().copy()
            for k in GRU_LEAVES}


@torch.no_grad()
def gru_init(in_dim: int, hidden: int, generator: torch.Generator,
             device="cuda") -> GRU:
    """Seeded random GRU: every leaf U(±1/√H) (uhc_tpu.learn.nets
    gru_init, torch nn.GRUCell's init)."""
    m = GRU(in_dim, hidden)
    lim = 1.0 / np.sqrt(hidden)
    for k in GRU_LEAVES:
        p = getattr(m, k)
        p.copy_(_uniform(p.shape, lim, generator))
    return m.to(device)


def _uniform(shape, lim, gen):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * lim


@torch.no_grad()
def _init_trunks(generator, *mlps):
    """torch nn.Linear's U(±1/√fan_in) init of every trunk layer."""
    for mlp in mlps:
        for w, b in zip(mlp.ws, mlp.bs):
            lim = 1.0 / np.sqrt(w.shape[-2])
            w.copy_(_uniform(w.shape, lim, generator))
            b.copy_(_uniform(b.shape, lim, generator))


@torch.no_grad()
def _init_head(mlp: MLP, generator):
    """The JAX init of an output head: 0.1-scaled weights, zero bias."""
    lim = 1.0 / np.sqrt(mlp.head_w.shape[-2])
    mlp.head_w.copy_(0.1 * _uniform(mlp.head_w.shape, lim, generator))
    mlp.head_b.zero_()


def policy_mcp_init(state_dim, action_dim, hidden, composer_hidden,
                    num_primitive, generator: torch.Generator,
                    activation="relu", device="cuda") -> PolicyMCP:
    """Seeded random MCP policy (torch nn.Linear's U(±1/√fan_in) init; the
    heads scaled by 0.1 with zero bias, as the JAX init)."""
    m = PolicyMCP(state_dim, action_dim, hidden, composer_hidden,
                  num_primitive, activation)
    _init_trunks(generator, m.prims, m.composer)
    _init_head(m.prims, generator)
    return m.to(device).eval()


def value_init(state_dim, hidden, generator: torch.Generator,
               activation="relu", device="cuda") -> Value:
    """Seeded random value net, initialized as the policy."""
    m = Value(state_dim, hidden, activation)
    _init_trunks(generator, m.net)
    _init_head(m.net, generator)
    return m.to(device).eval()


def policy_gaussian_init(state_dim, action_dim, hidden,
                         generator: torch.Generator, activation="relu",
                         device="cuda") -> PolicyGaussian:
    """Seeded random Gaussian policy (uhc_tpu.learn.nets
    policy_gaussian_init: U(±1/√fan_in) trunk, mean head scaled by 0.1
    with zero bias)."""
    m = PolicyGaussian(state_dim, action_dim, hidden, activation)
    _init_trunks(generator, m.net)
    _init_head(m.net, generator)
    return m.to(device).eval()


@torch.no_grad()
def policy_transformer_init(n_tokens, token_dim, global_dim, action_dim,
                            generator: torch.Generator, d_model=128,
                            nhead=4, ff_dim=256, nlayers=2,
                            device="cuda") -> PolicyTransformer:
    """Seeded random transformer policy (uhc_tpu.learn.nets
    policy_transformer_init): U(±1/√fan_in) affine layers, unit layer
    norms, both heads scaled by 0.01 with zero bias."""
    m = PolicyTransformer(n_tokens, token_dim, global_dim, action_dim,
                          d_model, nhead, ff_dim, nlayers)
    affine = [m.embed] + [lp[k] for lp in m.layers
                          for k in ("wqkv", "wo", "ff1", "ff2")]
    for p in affine + [m.head_tok, m.head_glob]:
        lim = 1.0 / np.sqrt(p["w"].shape[0])
        p["w"].copy_(_uniform(p["w"].shape, lim, generator))
        p["b"].copy_(_uniform(p["b"].shape, lim, generator))
    for p in (m.head_tok, m.head_glob):
        p["w"].mul_(0.01)
        p["b"].zero_()
    return m.to(device).eval()


def make_policy(cfg, state_dim, action_dim, generator: torch.Generator,
                device="cuda", n_tokens: int | None = None,
                token_dim: int | None = None) -> nn.Module:
    """The policy of `cfg.actor_type` (uhc_tpu.learn.nets make_policy):
    "mcp", "transformer" (which needs the token layout: n_tokens rows of
    token_dim after a global block) or else the Gaussian."""
    if cfg.actor_type == "transformer":
        if n_tokens is None or token_dim is None:
            raise ValueError("actor_type=transformer needs n_tokens and "
                             "token_dim (per-body observation rows)")
        return policy_transformer_init(
            n_tokens, token_dim, state_dim - n_tokens * token_dim,
            action_dim, generator, device=device)
    if cfg.actor_type == "mcp":
        return policy_mcp_init(state_dim, action_dim, cfg.policy_hsize,
                               cfg.composer_dim, cfg.num_primitive,
                               generator, cfg.policy_htype, device)
    return policy_gaussian_init(state_dim, action_dim, cfg.policy_hsize,
                                generator, cfg.policy_htype, device)


# ---------------------------------------------------------------------------
# The rest of the model zoo (uhc_tpu.learn.nets:119-185, 244-273, 409-707).
# Each module's submodules carry the names of the JAX init's tree, so
# `_zoo_load` fills a module from that tree and `_zoo_dump` writes it back;
# a tree's non-array entries (an LSTM's width, a video net's type) are
# constructor arguments here, and each module's `meta()` gives them back.
# ---------------------------------------------------------------------------


def _conv(cout: int, cin: int, *k: int) -> nn.ParameterDict:
    return nn.ParameterDict({"w": nn.Parameter(torch.zeros((cout, cin) + k)),
                             "b": nn.Parameter(torch.zeros(cout))})


def _layers(in_dim: int, hidden: Sequence[int]) -> nn.ModuleList:
    dims = [in_dim] + list(hidden)
    return nn.ModuleList(_affine(a, b) for a, b in zip(dims[:-1], dims[1:]))


def _lin(p, x):
    return x @ p["w"] + p["b"]


def _mlp(layers, x, activation: str):
    act = ACTIVATIONS[activation]
    for p in layers:
        x = act(_lin(p, x))
    return x


def _conv1d(p, x, dilation: int, causal: bool):
    """(B, C_in, T) -> (B, C_out, T): 'same' length, padded (pad // 2,
    pad - pad // 2) as the JAX function pads (asymmetric where (k - 1)·d
    is odd), or (pad, 0) when causal."""
    pad = (p["w"].shape[-1] - 1) * dilation
    x = F.pad(x, (pad, 0) if causal else (pad // 2, pad - pad // 2))
    return F.conv1d(x, p["w"], p["b"], dilation=dilation)


def _same(n: int, k: int, s: int) -> tuple:
    """XLA's "SAME" padding of one axis: total = max((⌈n/s⌉ - 1)·s + k - n,
    0), low total // 2, high the rest."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv2d_same(p, x, stride: int, groups: int = 1):
    kh, kw = p["w"].shape[-2:]
    x = F.pad(x, _same(x.shape[-1], kw, stride)
              + _same(x.shape[-2], kh, stride))
    return F.conv2d(x, p["w"], p["b"], stride=stride, groups=groups)


class TCN(nn.Module):
    """Dilated temporal conv net (tcn_apply): level i is a residual block
    of two ReLU'd convs at dilation 2^i plus a 1×1 downsample of its input
    where the widths differ; (B, C, T) -> (B, C_last, T)."""

    def __init__(self, num_inputs: int, num_channels: Sequence[int],
                 kernel_size: int = 3):
        super().__init__()
        self.layers = nn.ModuleList()
        last = num_inputs
        for ch in num_channels:
            block = nn.ModuleDict({"conv1": _conv(ch, last, kernel_size),
                                   "conv2": _conv(ch, ch, kernel_size)})
            if last != ch:
                block["downsample"] = _conv(ch, last, 1)
            self.layers.append(block)
            last = ch

    def forward(self, x, causal: bool = False):
        for i, block in enumerate(self.layers):
            out = torch.relu(_conv1d(block["conv1"], x, 2 ** i, causal))
            out = torch.relu(_conv1d(block["conv2"], out, 2 ** i, causal))
            res = (_conv1d(block["downsample"], x, 1, causal)
                   if "downsample" in block else x)
            x = torch.relu(out + res)
        return x


class Discriminator(nn.Module):
    """MLP trunk -> sigmoid of one logit (discriminator_apply)."""

    TREE = ("trunk", "logic")

    def __init__(self, in_dim: int, hidden: Sequence[int],
                 activation: str = "relu"):
        super().__init__()
        self.activation = activation
        self.trunk = _layers(in_dim, hidden)
        self.logic = _affine(hidden[-1], 1)

    def forward(self, x):
        h = _mlp(self.trunk, x, self.activation)
        return torch.sigmoid(_lin(self.logic, h))[..., 0]


class PolicyDiscrete(nn.Module):
    """MLP trunk -> action logits (policy_discrete_logits)."""

    TREE = ("trunk", "head")

    def __init__(self, state_dim: int, action_num: int,
                 hidden: Sequence[int], activation: str = "relu"):
        super().__init__()
        self.activation = activation
        self.trunk = _layers(state_dim, hidden)
        self.head = _affine(hidden[-1], action_num)

    def forward(self, x):
        return _lin(self.head, _mlp(self.trunk, x, self.activation))


def categorical_sample(generator: torch.Generator, logits):
    """One action per row by the Gumbel-max rule (JAX's
    random.categorical); the uniforms come from `generator` on the CPU."""
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype)
    tiny = torch.finfo(logits.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + g.to(logits.device), -1)


def categorical_log_prob(logits, action):
    logp = torch.log_softmax(logits, -1)
    return torch.gather(logp, -1, action[..., None].long())[..., 0]


def categorical_kl(logits_p, logits_q):
    """KL(p ‖ q) between two categorical heads."""
    lp = torch.log_softmax(logits_p, -1)
    lq = torch.log_softmax(logits_q, -1)
    return (torch.exp(lp) * (lp - lq)).sum(-1)


class LSTMCell(nn.Module):
    """One LSTM step (lstm_apply): a single (in + H, 4H) matrix over
    [x, h] with one bias, gates i, f, g, o; returns (h', (h', c'))."""

    TREE = ("wi",)

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hdim = hidden
        self.wi = _affine(in_dim + hidden, 4 * hidden)

    def meta(self) -> dict:
        return {"hdim": self.hdim}

    def forward(self, x, state):
        h, c = state
        hd = self.hdim
        z = _lin(self.wi, torch.cat([x, h], -1))
        i = torch.sigmoid(z[..., :hd])
        f = torch.sigmoid(z[..., hd:2 * hd])
        g = torch.tanh(z[..., 2 * hd:3 * hd])
        o = torch.sigmoid(z[..., 3 * hd:])
        c2 = f * c + i * g
        h2 = o * torch.tanh(c2)
        return h2, (h2, c2)


class ERD(nn.Module):
    """ERDNet (erd_apply): MLP(500) encoder -> linear -> LSTM(1000) × 2 ->
    MLP(500, 100) decoder -> linear(state_dim), over (T, B, state_dim).
    The encoder and decoder run on every step at once; the two LSTMs step
    through time."""

    TREE = ("enc_mlp", "enc_lin", "lstm1", "lstm2", "dec_mlp", "dec_lin")
    HIDDEN = 1000

    def __init__(self, state_dim: int):
        super().__init__()
        self.enc_mlp = _layers(state_dim, (500,))
        self.enc_lin = _affine(500, 500)
        self.lstm1 = LSTMCell(500, self.HIDDEN)
        self.lstm2 = LSTMCell(self.HIDDEN, self.HIDDEN)
        self.dec_mlp = _layers(self.HIDDEN, (500, 100))
        self.dec_lin = _affine(100, state_dim)

    def forward(self, x_seq, state=None):
        """Returns ((T, B, state_dim), (h1, c1, h2, c2))."""
        if state is None:
            z = x_seq.new_zeros((x_seq.shape[1], self.HIDDEN))
            state = (z, z, z, z)
        h1, c1, h2, c2 = state
        e = _lin(self.enc_lin, _mlp(self.enc_mlp, x_seq, "relu"))
        outs = []
        for t in range(x_seq.shape[0]):
            o1, (h1, c1) = self.lstm1(e[t], (h1, c1))
            o2, (h2, c2) = self.lstm2(o1, (h2, c2))
            outs.append(o2)
        d = _mlp(self.dec_mlp, torch.stack(outs), "relu")
        return _lin(self.dec_lin, d), (h1, c1, h2, c2)


class CMLP(nn.Module):
    """Conditioned MLP (cmlp_apply): every layer reads [c, x]."""

    TREE = ("layers",)

    def __init__(self, input_dim: int, cond_dim: int,
                 hidden: Sequence[int] = (128, 128),
                 activation: str = "tanh"):
        super().__init__()
        self.activation = activation
        dims = [input_dim] + list(hidden)
        self.layers = nn.ModuleList(_affine(a + cond_dim, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, c, x):
        act = ACTIVATIONS[self.activation]
        for p in self.layers:
            x = act(_lin(p, torch.cat([c, x], -1)))
        return x


class SimpleCNN(nn.Module):
    """Three stride-4 4×4 convs and a linear head (simple_cnn_apply):
    (B, 3, 224, 224) -> (B, out_dim)."""

    TREE = ("c1", "c2", "c3", "fc")

    def __init__(self, out_dim: int):
        super().__init__()
        self.c1 = _conv(32, 3, 4, 4)
        self.c2 = _conv(32, 32, 4, 4)
        self.c3 = _conv(16, 32, 4, 4)
        self.fc = _affine(144, out_dim)

    def forward(self, x):
        for p in (self.c1, self.c2, self.c3):
            x = torch.relu(F.conv2d(x, p["w"], p["b"], stride=4))
        return _lin(self.fc, x.reshape(x.shape[0], -1))


class ResNetFeat(nn.Module):
    """Residual CNN features (resnet_feat_apply): a stride-4 4×4 stem,
    `blocks` residual pairs of 3×3 "SAME" convs, a global mean pool and a
    linear head; (B, 3, H, W) -> (B, out_dim)."""

    TREE = ("stem", "blocks", "fc")

    def __init__(self, out_dim: int, width: int = 32, blocks: int = 3):
        super().__init__()
        self.stem = _conv(width, 3, 4, 4)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"a": _conv(width, width, 3, 3),
                           "b": _conv(width, width, 3, 3)})
            for _ in range(blocks))
        self.fc = _affine(width, out_dim)

    def forward(self, x):
        x = torch.relu(F.conv2d(x, self.stem["w"], self.stem["b"], stride=4))
        for blk in self.blocks:
            y = torch.relu(_conv2d_same(blk["a"], x, 1))
            x = torch.relu(x + _conv2d_same(blk["b"], y, 1))
        return _lin(self.fc, x.mean((2, 3)))


MOBILE_STAGES = ((32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
                 (256, 256, 1), (256, 512, 2), (512, 512, 1), (512, 512, 1),
                 (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 1024, 2),
                 (1024, 1024, 1))


class MobileNet(nn.Module):
    """MobileNet-v1 features (mobile_net_apply): a stride-2 3×3 stem, 13
    depthwise-separable stages (a 3×3 depthwise conv, groups = its input
    width, at the stage's stride, then a 1×1 conv; every conv "SAME" and
    ReLU'd), a global mean pool, a linear head."""

    TREE = ("stem", "stages", "fc")

    def __init__(self, out_dim: int):
        super().__init__()
        self.stem = _conv(32, 3, 3, 3)
        self.stages = nn.ModuleList(
            nn.ModuleDict({"dw": _conv(cin, 1, 3, 3),
                           "pw": _conv(cout, cin, 1, 1)})
            for cin, cout, _ in MOBILE_STAGES)
        self.fc = _affine(1024, out_dim)

    def forward(self, x):
        x = torch.relu(_conv2d_same(self.stem, x, 2))
        for st, (cin, _, stride) in zip(self.stages, MOBILE_STAGES):
            x = torch.relu(_conv2d_same(st["dw"], x, stride, groups=cin))
            x = torch.relu(_conv2d_same(st["pw"], x, 1))
        return _lin(self.fc, x.mean((2, 3)))


class VideoStateNet(nn.Module):
    """Temporal net over per-frame features (video_state_net_apply): a
    TCN, or a GRU stepped through time; (T, feat) -> (T, out)."""

    TREE = ("net",)

    def __init__(self, cnn_feat_dim: int, v_hdim: int = 128,
                 v_net_type: str = "gru", tcn_size=(64, 128),
                 kernel_size: int = 3):
        super().__init__()
        self.type, self.hdim = v_net_type, v_hdim
        self.net = (TCN(cnn_feat_dim, tcn_size, kernel_size)
                    if v_net_type == "tcn" else GRU(cnn_feat_dim, v_hdim))

    def meta(self) -> dict:
        return ({"type": "tcn"} if self.type == "tcn"
                else {"type": "gru", "hdim": self.hdim})

    def forward(self, feats, causal: bool = False):
        if self.type == "tcn":
            return self.net(feats.T[None], causal)[0].T
        h = feats.new_zeros(self.hdim)
        outs = []
        for x in feats:
            h = self.net(x, h)
            outs.append(h)
        return torch.stack(outs)


class VideoRegNet(nn.Module):
    """Per-frame CNN (MobileNet or the ResNet features) -> temporal net ->
    ReLU MLP -> linear regression head (video_reg_net_apply);
    (T, 3, H, W) -> (T, out_dim)."""

    TREE = ("cnn", "v_net", "mlp", "fc")

    def __init__(self, out_dim: int, v_hdim: int, cnn_fdim: int,
                 cnn_type: str = "resnet", v_net_type: str = "gru",
                 mlp_dim=(300, 200), tcn_size=(64, 128)):
        super().__init__()
        self.cnn_type = cnn_type
        self.cnn = (MobileNet(cnn_fdim) if cnn_type == "mobile"
                    else ResNetFeat(cnn_fdim))
        self.v_net = VideoStateNet(cnn_fdim, v_hdim, v_net_type, tcn_size)
        self.mlp = _layers(v_hdim, mlp_dim)
        self.fc = _affine(mlp_dim[-1], out_dim)

    def meta(self) -> dict:
        return {"cnn_type": self.cnn_type}

    def forward(self, frames, causal: bool = False):
        v = self.v_net(self.cnn(frames), causal)
        return _lin(self.fc, _mlp(self.mlp, v, "relu"))


class VideoForecastNet(nn.Module):
    """A GRU video branch summarizing the first `v_margin` frames' CNN
    features into a fixed context, and a state branch ("id" or a GRU);
    `initialize` and `forward` are video_forecast_initialize and
    video_forecast_step."""

    TREE = ("v_net",)

    def __init__(self, cnn_feat_dim: int, state_dim: int, v_hdim: int = 128,
                 v_margin: int = 10, s_net_type: str = "id", s_hdim=None):
        super().__init__()
        self.s_hdim = state_dim if s_hdim is None else s_hdim
        self.v_margin, self.s_net_type = v_margin, s_net_type
        self.out_dim = v_hdim + self.s_hdim
        self.v_net = VideoStateNet(cnn_feat_dim, v_hdim)
        if s_net_type == "gru":
            self.TREE = ("v_net", "s_net")
            self.s_net = GRU(state_dim, self.s_hdim)

    def meta(self) -> dict:
        m = {"v_margin": self.v_margin, "s_net_type": self.s_net_type,
             "out_dim": self.out_dim}
        if self.s_net_type == "gru":
            m["s_hdim"] = self.s_hdim
        return m

    def initialize(self, cnn_feats):
        """-> (the last causal video output over the margin, the state
        branch's zero state or None)."""
        v = self.v_net(cnn_feats[:self.v_margin], causal=True)
        s = (cnn_feats.new_zeros(self.s_hdim) if self.s_net_type == "gru"
             else None)
        return v[-1], s

    def forward(self, v_out, s_state, state):
        """-> (concat(video context, state encoding), the next s_state)."""
        if self.s_net_type == "gru":
            s_state = self.s_net(state, s_state)
            s = s_state
        else:
            s = state
        return torch.cat([v_out, s], -1), s_state


def _is_array_tree(v) -> bool:
    return isinstance(v, (dict, list, tuple)) or (
        not isinstance(v, str) and np.ndim(v) > 0)


def _tree_keys(module) -> list:
    if isinstance(module, (nn.ModuleDict, nn.ParameterDict)):
        return list(module.keys())
    if isinstance(module, GRU):
        return list(GRU_LEAVES)
    return list(module.TREE)


def _child(module, k):
    return (module[k] if isinstance(module, (nn.ModuleDict, nn.ParameterDict))
            else getattr(module, k))


def _zoo_load(module, tree) -> None:
    """Copy a JAX zoo tree onto `module`; the tree's arrays and the
    module's parameters must pair up one to one."""
    if isinstance(module, nn.Parameter):
        _set(module, tree)
        return
    if isinstance(module, TCN):
        module = module.layers
    if isinstance(module, (nn.ModuleList, nn.ParameterList)):
        if len(module) != len(tree):
            raise ValueError(f"{len(tree)} entries for {len(module)} layers")
        for m, v in zip(module, tree):
            _zoo_load(m, v)
        return
    keys = _tree_keys(module)
    extra = {k for k, v in tree.items() if _is_array_tree(v)} - set(keys)
    if extra:
        raise ValueError(f"arrays {sorted(extra)} have no parameter")
    for k in keys:
        _zoo_load(_child(module, k), tree[k])


def _zoo_dump(module):
    """A module -> the JAX init's tree (numpy arrays and its meta())."""
    if isinstance(module, nn.Parameter):
        return module.detach().cpu().numpy().copy()
    if isinstance(module, TCN):
        module = module.layers
    if isinstance(module, (nn.ModuleList, nn.ParameterList)):
        return [_zoo_dump(m) for m in module]
    out = {k: _zoo_dump(_child(module, k)) for k in _tree_keys(module)}
    if hasattr(module, "meta"):
        out.update(module.meta())
    return out


def _loaded(module: nn.Module, tree, device) -> nn.Module:
    _zoo_load(module, tree)
    return module.to(device).eval()


def _widths(layers) -> list:
    return [np.shape(p["w"])[-1] for p in layers]


def tcn_from_numpy(params, device="cuda") -> TCN:
    w = np.shape(params[0]["conv1"]["w"])
    return _loaded(TCN(w[1], [np.shape(b["conv1"]["w"])[0] for b in params],
                       w[-1]), params, device)


def discriminator_from_numpy(params, activation: str = "relu",
                             device="cuda") -> Discriminator:
    trunk = params["trunk"]
    return _loaded(Discriminator(np.shape(trunk[0]["w"])[0], _widths(trunk),
                                 activation), params, device)


def policy_discrete_from_numpy(params, activation: str = "relu",
                               device="cuda") -> PolicyDiscrete:
    trunk = params["trunk"]
    return _loaded(PolicyDiscrete(
        np.shape(trunk[0]["w"])[0], np.shape(params["head"]["w"])[1],
        _widths(trunk), activation), params, device)


def lstm_from_numpy(params, device="cuda") -> LSTMCell:
    rows, cols = np.shape(params["wi"]["w"])
    return _loaded(LSTMCell(rows - cols // 4, cols // 4), params, device)


def erd_from_numpy(params, device="cuda") -> ERD:
    return _loaded(ERD(np.shape(params["enc_mlp"][0]["w"])[0]), params,
                   device)


def cmlp_from_numpy(params, cond_dim: int, activation: str = "tanh",
                    device="cuda") -> CMLP:
    layers = params["layers"]
    return _loaded(CMLP(np.shape(layers[0]["w"])[0] - cond_dim, cond_dim,
                        _widths(layers), activation), params, device)


def simple_cnn_from_numpy(params, device="cuda") -> SimpleCNN:
    return _loaded(SimpleCNN(np.shape(params["fc"]["w"])[1]), params, device)


def _resnet_feat(params) -> ResNetFeat:
    return ResNetFeat(np.shape(params["fc"]["w"])[1],
                      np.shape(params["stem"]["w"])[0], len(params["blocks"]))


def resnet_feat_from_numpy(params, device="cuda") -> ResNetFeat:
    return _loaded(_resnet_feat(params), params, device)


def mobile_net_from_numpy(params, device="cuda") -> MobileNet:
    return _loaded(MobileNet(np.shape(params["fc"]["w"])[1]), params, device)


def _video_state_net_args(params) -> dict:
    net = params["net"]
    if params["type"] == "tcn":
        w = np.shape(net[0]["conv1"]["w"])
        return dict(cnn_feat_dim=w[1], v_net_type="tcn",
                    tcn_size=[np.shape(b["conv1"]["w"])[0] for b in net],
                    kernel_size=w[-1])
    return dict(cnn_feat_dim=np.shape(net["w_ih"])[0],
                v_hdim=np.shape(net["w_hh"])[0], v_net_type="gru")


def video_state_net_from_numpy(params, device="cuda") -> VideoStateNet:
    return _loaded(VideoStateNet(**_video_state_net_args(params)), params,
                   device)


def video_reg_net_from_numpy(params, device="cuda") -> VideoRegNet:
    cnn = params["cnn"]
    v = _video_state_net_args(params["v_net"])
    mlp = params["mlp"]
    m = VideoRegNet(np.shape(params["fc"]["w"])[1], np.shape(mlp[0]["w"])[0],
                    np.shape(cnn["fc"]["w"])[1], params["cnn_type"],
                    v["v_net_type"], _widths(mlp), v.get("tcn_size",
                                                         (64, 128)))
    if params["cnn_type"] != "mobile":
        m.cnn = _resnet_feat(cnn)
    return _loaded(m, params, device)


def video_forecast_net_from_numpy(params, device="cuda") -> VideoForecastNet:
    v = _video_state_net_args(params["v_net"])
    gru = params["s_net_type"] == "gru"
    state_dim = (np.shape(params["s_net"]["w_ih"])[0] if gru
                 else int(params["out_dim"]) - v["v_hdim"])
    m = VideoForecastNet(v["cnn_feat_dim"], state_dim, v["v_hdim"],
                         int(params["v_margin"]), params["s_net_type"],
                         int(params["s_hdim"]) if gru else None)
    return _loaded(m, params, device)


# every zoo net -> the JAX init's tree (numpy arrays and the non-array
# entries its apply function reads)
tcn_to_numpy = discriminator_to_numpy = policy_discrete_to_numpy = _zoo_dump
lstm_to_numpy = erd_to_numpy = cmlp_to_numpy = simple_cnn_to_numpy = _zoo_dump
resnet_feat_to_numpy = mobile_net_to_numpy = _zoo_dump
video_state_net_to_numpy = video_reg_net_to_numpy = _zoo_dump
video_forecast_net_to_numpy = _zoo_dump


@torch.no_grad()
def zoo_init(module: nn.Module, generator: torch.Generator,
             device="cuda") -> nn.Module:
    """Seeded random weights for any zoo net, drawn as the JAX inits draw
    theirs (not the same numbers): affine layers U(±1/√fan_in), 2-D convs
    U(±1/√(c_in·k·k)), TCN convs 0.01·N(0, 1) with zero bias, GRU leaves
    U(±1/√H)."""
    tcn = {id(conv) for m in module.modules() if isinstance(m, TCN)
           for blk in m.layers for conv in blk.values()}
    for m in module.modules():
        if isinstance(m, GRU):
            lim = 1.0 / np.sqrt(m.hidden)
            for k in GRU_LEAVES:
                p = getattr(m, k)
                p.copy_(_uniform(p.shape, lim, generator))
        elif isinstance(m, nn.ParameterDict) and set(m.keys()) == {"w", "b"}:
            w, b = m["w"], m["b"]
            if id(m) in tcn:
                w.copy_(0.01 * torch.randn(w.shape, generator=generator))
                b.zero_()
                continue
            fan_in = w.shape[0] if w.dim() == 2 else int(np.prod(
                w.shape[1:]))
            lim = 1.0 / np.sqrt(fan_in)
            w.copy_(_uniform(w.shape, lim, generator))
            b.copy_(_uniform(b.shape, lim, generator))
    return module.to(device).eval()
