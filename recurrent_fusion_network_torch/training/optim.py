"""Optimizers and schedules of the XE step.

Counterpart of ``recurrent_fusion_network_tpu/training/optim.py``, whose
optax chain is, in order:

  * an elementwise clamp of every gradient to [-grad_clip, grad_clip] (a
    clamp, not norm clipping),
  * coupled weight decay, grad += weight_decay * param, on the clamped
    gradient,
  * for adam, optax's ``scale_by_adam`` (bias-corrected moments, eps outside
    the square root); for sgd, optax's ``trace`` when momentum is set,

giving an unscaled direction; ``apply_updates(params, direction, lr)``
applies the learning rate outside the state, so the per-epoch schedule
needs no new state. rmsprop, adagrad and adadelta are not ported yet.

The update runs as PyTorch's multi-tensor (``_foreach``) ops over the
parameter leaves and works in place where the JAX step donates buffers:
the gradients are clamped and decayed in theirs, the moments and the
parameters are updated in theirs.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops.initializers import tree_leaves, tree_map, tree_unflatten


class AdamState(NamedTuple):
    count: int  # steps taken
    mu: Any  # first moments, the params' tree layout
    nu: Any  # second moments


class SgdState(NamedTuple):
    trace: Any  # momentum buffers, or None without momentum


class Optimizer:
    """clamp -> coupled weight decay -> adam | sgd; see the module docstring."""

    def __init__(self, name: str, *, grad_clip: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 momentum: float = 0.0):
        self.name = name
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.b1, self.b2, self.eps, self.momentum = b1, b2, eps, momentum

    def init(self, params):
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        if self.name == "adam":
            return AdamState(count=0, mu=zeros(), nu=zeros())
        return SgdState(trace=zeros() if self.momentum else None)

    def update(self, grads, state, params):
        """-> (direction, state). Consumes ``grads`` and updates the state's
        moments in place."""
        g, p = tree_leaves(grads), tree_leaves(params)
        torch._foreach_clamp_min_(g, -self.grad_clip)
        torch._foreach_clamp_max_(g, self.grad_clip)
        if self.weight_decay:
            torch._foreach_add_(g, p, alpha=self.weight_decay)
        if self.name == "adam":
            b1, b2 = self.b1, self.b2
            mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
            count = state.count + 1
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            denom = torch._foreach_div(nu, 1 - b2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            direction = torch._foreach_div(mu, 1 - b1 ** count)
            torch._foreach_div_(direction, denom)
            return tree_unflatten(grads, direction), AdamState(count, state.mu, state.nu)
        if state.trace is None:
            return grads, state
        trace = tree_leaves(state.trace)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, g)
        return tree_unflatten(grads, trace), state


def make_optimizer(opt) -> Optimizer:
    name = opt.optim
    if name in ("rmsprop", "adagrad", "adadelta"):
        raise NotImplementedError(
            f"optim {name} is not ported yet (ROADMAP.md queue 1, M3 remainder)")
    if name not in ("adam", "sgd"):
        raise ValueError(f"optim not supported: {name}")
    return Optimizer(name, grad_clip=opt.grad_clip, weight_decay=opt.optim_weight_decay,
                     b1=opt.optim_adam_beta1, b2=opt.optim_adam_beta2,
                     eps=opt.optim_epsilon, momentum=opt.optim_momentum)


@torch.no_grad()
def apply_updates(params, direction, lr: float):
    """params -= lr * direction, in place; returns params."""
    torch._foreach_add_(tree_leaves(params), tree_leaves(direction), alpha=-lr)
    return params


def lr_for_epoch(opt, epoch: int, base_lr: float) -> float:
    """Epoch-staircase decay."""
    if epoch > opt.learning_rate_decay_start >= 0:
        frac = (epoch - opt.learning_rate_decay_start) // opt.learning_rate_decay_every
        return base_lr * (opt.learning_rate_decay_rate ** frac)
    return base_lr


def ss_prob_for_epoch(opt, epoch: int) -> float:
    """Scheduled-sampling ramp."""
    if epoch > opt.scheduled_sampling_start >= 0:
        frac = (epoch - opt.scheduled_sampling_start) // opt.scheduled_sampling_increase_every
        return min(opt.scheduled_sampling_increase_prob * frac,
                   opt.scheduled_sampling_max_prob)
    return 0.0
