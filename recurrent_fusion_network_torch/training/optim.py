"""Optimizers and schedules of the XE step.

Counterpart of ``recurrent_fusion_network_tpu/training/optim.py``, whose
optax chain is, in order:

  * an elementwise clamp of every gradient to [-grad_clip, grad_clip] (a
    clamp, not norm clipping),
  * coupled weight decay, grad += weight_decay * param, on the clamped
    gradient,
  * the optimizer's transform:
      adam      optax ``scale_by_adam`` (bias-corrected moments, eps outside
                the square root);
      sgd       optax ``trace`` when momentum is set;
      rmsprop   optax ``scale_by_rms(decay=alpha, eps, eps_in_sqrt=False)``:
                nu = alpha * nu + (1 - alpha) * g^2, g / (sqrt(nu) + eps),
                then optax ``trace`` when momentum is set;
      adagrad   the JAX package's ``scale_by_torch_adagrad``: sum += g^2,
                g / (sqrt(sum) + 1e-10) / (1 + (count - 1) * lr_decay),
                with an int32 step count;
      adadelta  optax ``scale_by_adadelta(rho, eps)``: e_g updated first,
                then the update sqrt(e_x + eps) / sqrt(e_g + eps) * g, then
                e_x from that update,

giving an unscaled direction; ``apply_updates(params, direction, lr)``
applies the learning rate outside the state, so the per-epoch schedule
needs no new state.

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


class RmspropState(NamedTuple):
    nu: Any  # moving average of the squared gradients
    trace: Any  # momentum buffers, or None without momentum


class AdagradState(NamedTuple):
    count: int  # steps taken (an int32 in the JAX package)
    sum_sq: Any  # accumulated squared gradients


class AdadeltaState(NamedTuple):
    e_g: Any  # moving average of the squared gradients
    e_x: Any  # moving average of the squared updates


STATES = {"adam": AdamState, "sgd": SgdState, "rmsprop": RmspropState,
          "adagrad": AdagradState, "adadelta": AdadeltaState}
ADAGRAD_EPS = 1e-10  # scale_by_torch_adagrad's eps (torch.optim.Adagrad's)


def state_to(state, device):
    """An optimizer state with every tensor moved to ``device`` (counts
    stay as they are)."""
    return type(state)(*(tree_map(lambda t: t.to(device), f) if not isinstance(f, int)
                         else f for f in state))


class Optimizer:
    """clamp -> coupled weight decay -> the named transform; see the module
    docstring."""

    def __init__(self, name: str, *, grad_clip: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 momentum: float = 0.0, alpha: float = 0.99, lr_decay: float = 0.0,
                 rho: float = 0.9):
        self.name = name
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.b1, self.b2, self.eps, self.momentum = b1, b2, eps, momentum
        self.alpha, self.lr_decay, self.rho = alpha, lr_decay, rho

    def init(self, params):
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        trace = zeros() if self.momentum else None
        return {"adam": lambda: AdamState(count=0, mu=zeros(), nu=zeros()),
                "sgd": lambda: SgdState(trace=trace),
                "rmsprop": lambda: RmspropState(nu=zeros(), trace=trace),
                "adagrad": lambda: AdagradState(count=0, sum_sq=zeros()),
                "adadelta": lambda: AdadeltaState(e_g=zeros(), e_x=zeros()),
                }[self.name]()

    def update(self, grads, state, params):
        """-> (direction, state). Consumes ``grads`` and updates the state's
        moments in place."""
        g, p = tree_leaves(grads), tree_leaves(params)
        torch._foreach_clamp_min_(g, -self.grad_clip)
        torch._foreach_clamp_max_(g, self.grad_clip)
        if self.weight_decay:
            torch._foreach_add_(g, p, alpha=self.weight_decay)
        direction = getattr(self, f"_{self.name}")(g, state)
        if isinstance(state, (SgdState, RmspropState)) and state.trace is not None:
            trace = tree_leaves(state.trace)
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, direction)
            direction = trace
        if isinstance(state, (AdamState, AdagradState)):
            state = state._replace(count=state.count + 1)
        return tree_unflatten(grads, direction), state

    # each: the transform's direction leaves from the clamped, decayed
    # gradient leaves g (which it may overwrite), the state updated in place

    def _adam(self, g, state):
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
        return direction

    def _sgd(self, g, state):
        return g

    def _rmsprop(self, g, state):
        nu = tree_leaves(state.nu)
        torch._foreach_mul_(nu, self.alpha)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.alpha)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(g, denom)
        return g

    def _adagrad(self, g, state):
        sum_sq = tree_leaves(state.sum_sq)
        torch._foreach_addcmul_(sum_sq, g, g)
        denom = torch._foreach_sqrt(sum_sq)
        torch._foreach_add_(denom, ADAGRAD_EPS)
        torch._foreach_div_(g, denom)
        # JAX: 1 / (1 + f32(count - 1) * lr_decay), count the new step's
        torch._foreach_mul_(g, 1.0 / (1.0 + state.count * self.lr_decay))
        return g

    def _adadelta(self, g, state):
        rho, eps = self.rho, self.eps
        e_g, e_x = tree_leaves(state.e_g), tree_leaves(state.e_x)
        torch._foreach_mul_(e_g, rho)
        torch._foreach_addcmul_(e_g, g, g, value=1 - rho)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        torch._foreach_mul_(g, num)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_addcmul_(e_x, g, g, value=1 - rho)
        return g


def state_fits(state, tx) -> bool:
    """Whether ``state`` (a resumed one) is the state of ``tx``'s optimizer,
    momentum buffers included."""
    if not isinstance(state, STATES[tx.name]):
        return False
    if tx.name in ("sgd", "rmsprop"):
        return (state.trace is None) == (not tx.momentum)
    return True


def make_optimizer(opt) -> Optimizer:
    name = opt.optim
    if name not in STATES:
        raise ValueError(f"optim not supported: {name}")
    return Optimizer(name, grad_clip=opt.grad_clip, weight_decay=opt.optim_weight_decay,
                     b1=opt.optim_adam_beta1, b2=opt.optim_adam_beta2,
                     eps=opt.optim_epsilon, momentum=opt.optim_momentum,
                     alpha=opt.optim_rmsprop_alpha,
                     lr_decay=getattr(opt, "optim_lr_decay", 0.0) or 0.0,
                     rho=opt.optim_rho)


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
