"""Floating-point operations (multiply-add = 2) of the networks' forward
pass for one row: the MCP policy (num_primitive trunk + head MLPs, the
composer MLP, the softmax-weighted mix) and the value MLP. Activations,
the softmax and the Gaussian's log-density are left out (a few per unit,
against the products' hundreds)."""
from __future__ import annotations


def _mlp(dims) -> float:
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))


def mcp_flops(obs_dim: int, act_dim: int, hidden, composer, primitives):
    prims = primitives * _mlp([obs_dim, *hidden, act_dim])
    comp = _mlp([obs_dim, *composer, primitives])
    return prims + comp + 2.0 * primitives * act_dim


def value_flops(obs_dim: int, hidden) -> float:
    return _mlp([obs_dim, *hidden, 1])
