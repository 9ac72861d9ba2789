"""JAX params tree (as numpy arrays) -> the port's parameter tree.

The port keeps the JAX package's layout at its public functions, so a
converted tree is the same tree with torch leaves:
  * a linear layer is ``{"w": (in, out), "b": (out,)}`` applied as
    ``x @ w + b`` (the transpose of ``nn.Linear.weight``);
  * untied review steps are stacked on a leading step axis (``review1[j]``:
    R0, ``review2``: S), and stage-II heads on M after it;
  * ``review1_keys`` / ``review2_keys`` exist only in the tied-keys profile
    and ``value_proj`` only under ``low_rank_ctx``;
  * ShowTell's ``core`` is a list of bias-free layers ``{"i2h": {"w"},
    "h2h": {"w"}}``;
  * ReviewNet's ``review`` cells are stacked on the step axis,
    ``review_keys`` exists only with tied keys, and ``mos.latent`` (under
    ``use_mos``) is stacked on the expert axis E.
``check_params`` holds a converted tree against the model's own layout, so
a checkpoint of another architecture fails with the path that differs.

The optimizer file of a JAX checkpoint is the optax chain's state, a tuple
with one entry per transform: ``EmptyState()`` for the clamp and the weight
decay, then the optimizer's: ``ScaleByAdamState(count, mu, nu)`` for adam;
for sgd with momentum ``TraceState(trace)``; for rmsprop
``ScaleByRmsState(nu)``, followed with momentum by ``TraceState(trace)``;
for adagrad the JAX package's ``ScaleByAdagradState(count, sum_sq)``; for
adadelta ``ScaleByAdaDeltaState(e_g, e_x)``. The checkpoint reader rebuilds
those classes as the ``Jax*State`` named tuples below, and
``opt_state_from_jax`` maps the chain to the port's optimizer states
(``training/optim.py``); ``params_to_jax`` and ``opt_state_to_jax`` go the
other way, for the checkpoint writer.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .ops.initializers import tree_map
from .training.optim import AdadeltaState, AdagradState, AdamState, RmspropState, SgdState


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


class JaxScaleByRmsState(NamedTuple):
    """optax ScaleByRmsState, as unpickled by the port."""

    nu: Any


class JaxScaleByAdagradState(NamedTuple):
    """The JAX package's training.optim.ScaleByAdagradState, as unpickled
    by the port."""

    count: Any
    sum_sq: Any


class JaxScaleByAdaDeltaState(NamedTuple):
    """optax ScaleByAdaDeltaState, as unpickled by the port."""

    e_g: Any
    e_x: Any


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
    parts = tuple(s for s in chain if not isinstance(s, JaxEmptyState))
    kinds = tuple(type(s) for s in parts)

    def tree(x, name):
        t = params_from_jax(x)
        if model is not None:
            check_params(model, t, name=name)
        return t

    if kinds == (JaxScaleByAdamState,):
        a = parts[0]
        return AdamState(int(np.asarray(a.count)), tree(a.mu, "mu"), tree(a.nu, "nu"))
    if kinds in ((), (JaxTraceState,)):
        return SgdState(tree(parts[0].trace, "trace") if parts else None)
    if kinds in ((JaxScaleByRmsState,), (JaxScaleByRmsState, JaxTraceState)):
        return RmspropState(tree(parts[0].nu, "nu"),
                            tree(parts[1].trace, "trace") if len(parts) > 1 else None)
    if kinds == (JaxScaleByAdagradState,):
        a = parts[0]
        return AdagradState(int(np.asarray(a.count)), tree(a.sum_sq, "sum_sq"))
    if kinds == (JaxScaleByAdaDeltaState,):
        return AdadeltaState(tree(parts[0].e_g, "e_g"), tree(parts[0].e_x, "e_x"))
    raise ValueError(
        f"unsupported optimizer state {[type(s).__name__ for s in chain]}: the port "
        "reads the chains of adam, sgd, rmsprop, adagrad and adadelta")


def opt_state_to_jax(state, opt):
    """The port's optimizer state -> the optax chain state the JAX package
    builds for ``opt`` (clamp, weight decay when ``optim_weight_decay``,
    then the optimizer's states), numpy leaves, counts int32 as the JAX
    package keeps them."""
    chain = [JaxEmptyState()]
    if opt.optim_weight_decay:
        chain.append(JaxEmptyState())
    if isinstance(state, AdamState):
        chain.append(JaxScaleByAdamState(np.asarray(state.count, np.int32),
                                         params_to_jax(state.mu), params_to_jax(state.nu)))
    elif isinstance(state, RmspropState):
        chain.append(JaxScaleByRmsState(params_to_jax(state.nu)))
    elif isinstance(state, AdagradState):
        chain.append(JaxScaleByAdagradState(np.asarray(state.count, np.int32),
                                            params_to_jax(state.sum_sq)))
    elif isinstance(state, AdadeltaState):
        chain.append(JaxScaleByAdaDeltaState(params_to_jax(state.e_g),
                                             params_to_jax(state.e_x)))
    if isinstance(state, (SgdState, RmspropState)) and state.trace is not None:
        chain.append(JaxTraceState(params_to_jax(state.trace)))
    return tuple(chain)
