"""JAX params tree (as numpy arrays) -> the port's parameter tree.

The port keeps the JAX package's layout at its public functions, so a
converted tree is the same tree with torch leaves:
  * a linear layer is ``{"w": (in, out), "b": (out,)}`` applied as
    ``x @ w + b`` (the transpose of ``nn.Linear.weight``);
  * untied review steps are stacked on a leading step axis (``review1[j]``:
    R0, ``review2``: S), and stage-II heads on M after it;
  * ``review1_keys`` / ``review2_keys`` exist only in the tied-keys profile
    and ``value_proj`` only under ``low_rank_ctx``.
``check_params`` holds a converted tree against the model's own layout, so
a checkpoint of another architecture fails with the path that differs.

The optimizer file of a JAX checkpoint is the optax chain's state, a tuple
with one entry per transform: ``EmptyState()`` for the clamp and the weight
decay, then ``ScaleByAdamState(count, mu, nu)`` for adam or, for sgd with
momentum, ``TraceState(trace)``. The checkpoint reader rebuilds those
classes as the ``Jax*State`` named tuples below, and ``opt_state_from_jax``
maps the chain to the port's ``AdamState`` / ``SgdState``; ``params_to_jax``
and ``opt_state_to_jax`` go the other way, for the checkpoint writer.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .ops.initializers import tree_map
from .training.optim import AdamState, SgdState


class JaxEmptyState(NamedTuple):
    """optax._src.base.EmptyState, as unpickled by the port."""


class JaxScaleByAdamState(NamedTuple):
    """optax ScaleByAdamState, as unpickled by the port."""

    count: Any
    mu: Any
    nu: Any


class JaxTraceState(NamedTuple):
    """optax TraceState, as unpickled by the port."""

    trace: Any


def _to_tensor(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"unsupported parameter leaf dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree):
    """Nested dict / list / tuple tree of numpy arrays -> the same tree of
    CPU torch tensors (copies; dtypes kept)."""
    return tree_map(_to_tensor, tree)


def params_to_jax(tree):
    """The port's tensor tree -> the same tree of numpy arrays (host
    copies), as the JAX package pickles its params."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def check_params(model, params, name: str = "params") -> None:
    """Raise ValueError where ``params`` (or a tree of the params' layout,
    such as an optimizer moment, called ``name``) differs from ``model``'s
    layout (missing or extra entries, shapes)."""
    ref = model.init_params(None, device="meta")  # shapes only, no storage

    def walk(r, p, path):
        if isinstance(r, dict):
            if not isinstance(p, dict) or set(r) != set(p):
                got = sorted(p) if isinstance(p, dict) else type(p).__name__
                raise ValueError(f"{name}{path}: expected keys {sorted(r)}, got {got}")
            for k in r:
                walk(r[k], p[k], f"{path}[{k!r}]")
        elif isinstance(r, (list, tuple)):
            if not isinstance(p, (list, tuple)) or len(r) != len(p):
                raise ValueError(f"{name}{path}: expected {len(r)} entries")
            for i, (a, b) in enumerate(zip(r, p)):
                walk(a, b, f"{path}[{i}]")
        elif tuple(r.shape) != tuple(p.shape):
            raise ValueError(
                f"{name}{path}: expected shape {tuple(r.shape)}, got {tuple(p.shape)}")

    walk(ref, params, "")


def opt_state_from_jax(chain, model=None):
    """An unpickled optax chain state -> the port's optimizer state (CPU
    tensors). With ``model``, every moment tree is held against the model's
    layout, so the state of another architecture fails with its path."""
    parts = [s for s in chain if not isinstance(s, JaxEmptyState)]
    if len(parts) > 1 or not all(isinstance(s, (JaxScaleByAdamState, JaxTraceState))
                                 for s in parts):
        raise ValueError(
            f"unsupported optimizer state {[type(s).__name__ for s in chain]}: the "
            "port reads the adam chain and sgd with or without momentum")
    trees = {}
    if parts and isinstance(parts[0], JaxScaleByAdamState):
        trees = {"mu": parts[0].mu, "nu": parts[0].nu}
    elif parts:
        trees = {"trace": parts[0].trace}
    trees = {k: params_from_jax(v) for k, v in trees.items()}
    if model is not None:
        for k, v in trees.items():
            check_params(model, v, name=k)
    if "mu" in trees:
        return AdamState(count=int(np.asarray(parts[0].count)), **trees)
    return SgdState(trace=trees.get("trace"))


def opt_state_to_jax(state, opt):
    """The port's optimizer state -> the optax chain state the JAX package
    builds for ``opt`` (clamp, weight decay when ``optim_weight_decay``,
    then adam or sgd's momentum trace), numpy leaves, ``count`` int32 as
    optax keeps it."""
    chain = [JaxEmptyState()]
    if opt.optim_weight_decay:
        chain.append(JaxEmptyState())
    if isinstance(state, AdamState):
        chain.append(JaxScaleByAdamState(np.asarray(state.count, np.int32),
                                         params_to_jax(state.mu), params_to_jax(state.nu)))
    elif state.trace is not None:
        chain.append(JaxTraceState(params_to_jax(state.trace)))
    return tuple(chain)
