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

``backbone_params_from_jax`` turns the JAX feature backbones' parameters
(``data/feature_extraction``) into the port's flat dicts.
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


# ---------------------------------------------------------------- backbones

_BN_FROM_JAX = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def _oihw(w) -> torch.Tensor:
    """An HWIO conv weight -> OIHW."""
    return _to_tensor(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def _flatten_jax_backbone(arch: str, params) -> dict:
    """The JAX resnet / densenet trees as {torchvision name: array}, conv
    weights still HWIO (names ending in "weight" with 4 dims)."""
    out = {}

    def conv(name, node):
        out[name + ".weight"] = node["w"]

    def bn(prefix, node):
        for leaf, key in _BN_FROM_JAX.items():
            out[f"{prefix}.{leaf}"] = node[key]

    if arch.startswith("resnet"):
        conv("conv1", params["conv1"])
        bn("bn1", params["bn1"])
        for stage in range(1, 5):
            for b, blk in enumerate(params[f"layer{stage}"]):
                pre = f"layer{stage}.{b}"
                for i in (1, 2, 3):
                    conv(f"{pre}.conv{i}", blk[f"conv{i}"])
                    bn(f"{pre}.bn{i}", blk[f"bn{i}"])
                if "downsample" in blk:
                    conv(f"{pre}.downsample.0", blk["downsample"]["conv"])
                    bn(f"{pre}.downsample.1", blk["downsample"]["bn"])
        return out
    conv("features.conv0", params["conv0"])
    bn("features.norm0", params["bn0"])
    bi = 1
    while f"block{bi}" in params:
        for li, layer in enumerate(params[f"block{bi}"], start=1):
            pre = f"features.denseblock{bi}.denselayer{li}"
            bn(pre + ".norm1", layer["bn1"])
            conv(pre + ".conv1", layer["conv1"])
            bn(pre + ".norm2", layer["bn2"])
            conv(pre + ".conv2", layer["conv2"])
        if f"trans{bi}" in params:
            bn(f"features.transition{bi}.norm", params[f"trans{bi}"]["bn"])
            conv(f"features.transition{bi}.conv", params[f"trans{bi}"]["conv"])
        bi += 1
    bn("features.norm5", params["bn_final"])
    return out


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_leaves(v) for v in tree)
    return 1


def backbone_params_from_jax(arch: str, params) -> dict:
    """A JAX backbone's parameters -> the port's: the resnet and densenet
    trees (nested dicts, NHWC / HWIO arrays) to flat torchvision-named
    dicts, the inception flat slim dicts key for key; conv weights HWIO ->
    OIHW. Every JAX leaf must be consumed and every parameter the port's
    trunk reads assigned, with its shape."""
    from .data.feature_extraction import densenet, inception, resnet

    if arch in inception._TRUNKS:
        expected = inception.param_shapes(arch)
        flat = dict(params)
        n_leaves = len(flat)
        out = {k: _oihw(v) if k.endswith("/w") else _to_tensor(v) for k, v in flat.items()}
    elif arch.startswith(("resnet", "densenet")):
        flat = _flatten_jax_backbone(arch, params)
        n_leaves = _count_leaves(params)
        out = {k: _oihw(v) if np.ndim(v) == 4 else _to_tensor(v) for k, v in flat.items()}
        if arch.startswith("resnet"):
            blocks = tuple(len(params[f"layer{s}"]) for s in range(1, 5))
            cfg = resnet.ResNetConfig(blocks=blocks, width=out["conv1.weight"].shape[0])
            expected = resnet.param_shapes(cfg)
        else:
            n_blocks = sum(1 for k in params if k.startswith("block"))
            blocks = tuple(len(params[f"block{b}"]) for b in range(1, n_blocks + 1))
            layer = params["block1"][0]
            growth = np.shape(layer["conv2"]["w"])[-1]
            cfg = densenet.DenseNetConfig(
                blocks=blocks, growth=growth, init_features=np.shape(params["conv0"]["w"])[-1],
                bn_size=np.shape(layer["conv1"]["w"])[-1] // growth)
            expected = densenet.param_shapes(cfg)
    else:
        raise ValueError(f"arch not supported: {arch}")
    if len(flat) != n_leaves:
        raise ValueError(f"{arch}: {n_leaves - len(flat)} JAX leaves not consumed")
    extra, missing = sorted(set(out) - set(expected)), sorted(set(expected) - set(out))
    if extra or missing:
        raise ValueError(f"{arch}: JAX parameters the port does not read {extra[:3]}, "
                         f"port parameters not assigned {missing[:3]}")
    for k, shape in expected.items():
        if tuple(out[k].shape) != tuple(shape):
            raise ValueError(f"{arch}: {k} has shape {tuple(out[k].shape)}, the port's "
                             f"trunk reads {tuple(shape)}")
    return {k: out[k] for k in expected}
