"""The policy and value networks written out plainly, over a dict of
parameters named as the program's modules name them: the MCP policy
(num_primitive trunk + head MLPs mixed by a softmax over an activated
composer MLP) and the value MLP; their seeded initialization; the
diagonal Gaussian's log-density."""
from __future__ import annotations

import math

import torch

ACT = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
       "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh")}


def _uniform(shape, lim, gen):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * lim


def init_params(cfg, obs_dim: int, act_dim: int, seed: int):
    """(policy, value) parameter dicts of the MCP policy and the value net
    drawn from `seed`: each trunk layer's weight then bias U(±1/√fan_in)
    (the primitives' trunk, then the composer's), then the primitives'
    head at 0.1 of that with zero bias; then the value net likewise, from
    the same stream."""
    gen = torch.Generator().manual_seed(seed)
    P, h = cfg.num_primitive, list(cfg.policy_hsize)

    def trunk(prefix, dims, lead):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            lim = 1.0 / math.sqrt(a)
            out[prefix][f"ws.{i}"] = _uniform(lead + (a, b), lim, gen)
            out[prefix][f"bs.{i}"] = _uniform(lead + (b,), lim, gen)

    def head(prefix, a, b, lead):
        lim = 1.0 / math.sqrt(a)
        out[prefix]["head_w"] = 0.1 * _uniform(lead + (a, b), lim, gen)
        out[prefix]["head_b"] = torch.zeros(lead + (b,))

    out = {"prims": {}, "composer": {}, "net": {}}
    trunk("prims", [obs_dim] + h, (P,))
    trunk("composer", [obs_dim] + list(cfg.composer_dim) + [P], ())
    head("prims", h[-1], act_dim, (P,))
    vh = list(cfg.value_hsize)
    trunk("net", [obs_dim] + vh, ())
    head("net", vh[-1], 1, ())
    pol = {f"{net}.{k}": v for net in ("prims", "composer")
           for k, v in out[net].items()}
    val = {"net." + k: v for k, v in out["net"].items()}
    return pol, val


def _layers(p, prefix):
    n = sum(1 for k in p if k.startswith(prefix + "ws."))
    return [(p[f"{prefix}ws.{i}"], p[f"{prefix}bs.{i}"]) for i in range(n)]


def mcp_mean(p: dict, x, act: str = "relu"):
    """The MCP policy's mean action for observations x (B, D)."""
    f = ACT[act]
    h = x.expand((p["prims.head_w"].shape[0],) + x.shape)
    for w, b in _layers(p, "prims."):
        h = f(torch.matmul(h, w) + b.unsqueeze(-2))
    means = torch.matmul(h, p["prims.head_w"]) + \
        p["prims.head_b"].unsqueeze(-2)                     # (P, B, A)
    c = x
    for w, b in _layers(p, "composer."):
        c = f(c @ w + b)
    wts = torch.softmax(c, dim=-1)                           # (B, P)
    return torch.einsum("bp,pba->ba", wts, means)


def value(p: dict, x, act: str = "relu"):
    """The value net's (B,) output."""
    f = ACT[act]
    h = x
    for w, b in _layers(p, "net."):
        h = f(h @ w + b)
    return (h @ p["net.head_w"] + p["net.head_b"])[..., 0]


def log_prob(mean, log_std, action):
    """Diagonal Gaussian log-density summed over the action axis."""
    var = torch.exp(2.0 * log_std)
    return (-((action - mean) ** 2) / (2 * var)
            - 0.5 * math.log(2 * math.pi) - log_std).sum(-1)
