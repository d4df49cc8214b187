"""Policy and value networks (PyTorch twin of uhc_tpu.learn.nets: the MLP
trunk, the Gaussian policy mean, the multiplicative compositional (MCP)
policy mean, the transformer policy mean over per-body tokens, the value
head, the GRU cell of the kinematic policy and the diagonal Gaussian's
log-density and KL).

Weights use the JAX package's (in, out) layout so a checkpoint's parameter
tree carries across unchanged: `policy_from_numpy` / `value_from_numpy`
take the nested dicts and lists of numpy arrays of a checkpoint pickle,
`policy_to_numpy` / `value_to_numpy` write them.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch
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
