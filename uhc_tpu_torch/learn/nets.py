"""Policy and value networks (PyTorch twin of uhc_tpu.learn.nets: the MLP
trunk, the Gaussian policy mean, the multiplicative compositional (MCP)
policy mean and the value head).

Weights use the JAX package's (in, out) layout so a checkpoint's parameter
tree carries across unchanged: `policy_from_numpy` / `value_from_numpy`
take the nested dicts and lists of numpy arrays of a checkpoint pickle,
`policy_to_numpy` / `value_to_numpy` write them.
"""
from __future__ import annotations

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


def _set(p: nn.Parameter, v) -> None:
    v = torch.as_tensor(np.asarray(v, np.float32))
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


def policy_from_numpy(params, activation: str = "relu",
                      device="cuda") -> nn.Module:
    """JAX policy parameter tree (nested dicts/lists of numpy arrays) ->
    PolicyMCP or PolicyGaussian module on `device`."""
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


def policy_to_numpy(m: nn.Module) -> dict:
    """PolicyMCP / PolicyGaussian -> the JAX parameter tree (numpy)."""
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


def make_policy(cfg, state_dim, action_dim, generator: torch.Generator,
                device="cuda") -> nn.Module:
    """The policy of `cfg.actor_type` (uhc_tpu.learn.nets make_policy):
    "mcp" or "gauss"."""
    if cfg.actor_type == "mcp":
        return policy_mcp_init(state_dim, action_dim, cfg.policy_hsize,
                               cfg.composer_dim, cfg.num_primitive,
                               generator, cfg.policy_htype, device)
    if cfg.actor_type == "gauss":
        return policy_gaussian_init(state_dim, action_dim, cfg.policy_hsize,
                                    generator, cfg.policy_htype, device)
    raise NotImplementedError(f"actor_type {cfg.actor_type!r} is not "
                              "ported yet")
