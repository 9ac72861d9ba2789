"""Parameter initializers and the linear-layer convention.

Counterpart of ``recurrent_fusion_network_tpu/ops/initializers.py``: most
weights U(-0.1, 0.1), some biases filled with constants, the rest at the
``nn.Linear`` default U(-1/sqrt(fan_in), 1/sqrt(fan_in)). Draws come from an
explicit ``torch.Generator`` (they cannot reproduce JAX's bits; converted
JAX weights reach the tests through ``convert.params_from_jax``).

Linear layers are ``{"w": (in, out), "b": (out,)}`` applied as
``x @ w + b``: the JAX package's layout, kept so converted trees need no
transposes. Parameter trees are nested dicts / lists / tuples of tensors.
"""

from __future__ import annotations

import math

import torch

INITRANGE = 0.1


def uniform(generator, shape, scale=INITRANGE, *, device, dtype=torch.float32):
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return u.mul_(2 * scale).sub_(scale)


def linear(generator, in_dim: int, out_dim: int, *, weight: str = "uniform",
           bias="default", device, dtype=torch.float32):
    """weight: "uniform" -> U(-0.1, 0.1); "default" -> nn.Linear default.
    bias: "uniform" | "default" | float fill | None (no bias)."""
    bound = 1.0 / math.sqrt(in_dim)
    if weight == "uniform":
        w = uniform(generator, (in_dim, out_dim), device=device, dtype=dtype)
    elif weight == "default":
        w = uniform(generator, (in_dim, out_dim), bound, device=device, dtype=dtype)
    else:
        raise ValueError(weight)
    params = {"w": w}
    if bias is None:
        return params
    if bias == "uniform":
        params["b"] = uniform(generator, (out_dim,), device=device, dtype=dtype)
    elif bias == "default":
        params["b"] = uniform(generator, (out_dim,), bound, device=device, dtype=dtype)
    elif isinstance(bias, (int, float)):
        params["b"] = torch.full((out_dim,), float(bias), device=device, dtype=dtype)
    else:
        raise ValueError(bias)
    return params


def apply_linear(params, x):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def tree_map(fn, tree):
    """Apply fn to every leaf of a nested dict / list / tuple tree (None
    leaves pass through)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree, leaves):
    """``tree`` with its leaves replaced by ``leaves``, in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def stack_params(param_list):
    """Stack identically-shaped param trees along a new leading axis (the
    untied review steps, the stage-II heads)."""
    first = param_list[0]
    if isinstance(first, dict):
        return {k: stack_params([p[k] for p in param_list]) for k in first}
    return torch.stack(param_list, dim=0)


def index_params(tree, i: int):
    """Row i of every leaf of a stacked tree (a view, no copy)."""
    return tree_map(lambda x: x[i], tree)
