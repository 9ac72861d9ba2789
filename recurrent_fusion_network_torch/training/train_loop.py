"""Cross-entropy training loop.

Counterpart of ``recurrent_fusion_network_tpu/training/train_loop.py``:
``make_train_step`` (forward, the ensemble criterion, gradients, then the
clamp -> weight-decay -> Adam update) and ``train`` (per-epoch lr and
scheduled-sampling schedule, loss/lr/ss histories, the ``--xe_overlap``
order, resume from a checkpoint triple the JAX package wrote).

Not ported yet (ROADMAP.md queue 1, M6): periodic eval_split, checkpoint
writing, preemption saves and the data loader. ``train`` takes any loader
whose ``get_batch("train")`` returns the JAX loader's batch dict, and raises
``NotImplementedError`` at an eval / checkpoint boundary instead of skipping
it. Multi-device meshes are M10.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..convert import check_params, opt_state_from_jax, params_from_jax
from ..device import resolve_device
from ..models import setup
from ..ops.initializers import tree_leaves, tree_map, tree_unflatten
from .checkpoint import assert_arch_matches, cast_tree, load_checkpoint, load_optimizer
from .criterion import make_criterion
from .optim import (AdamState, SgdState, apply_updates, lr_for_epoch, make_optimizer,
                    ss_prob_for_epoch)


def make_train_step(model, crit, tx, compute_dtype=None):
    """XE train step: (params, opt_state, fc, att, labels, masks, top_words,
    lr, ss_prob, generator) -> (params, opt_state, loss).

    compute_dtype=torch.bfloat16 is the mixed-precision policy (--dtype
    bfloat16): master params, gradients and moments stay f32 while the
    forward and backward run in bf16. The f32 leaves are cast inside the
    differentiated function (not autocast), so each cast's backward returns
    its gradient to f32; log-softmax and the XE stay f32. The update works
    in place on params and opt_state (the JAX step donates both). The loss
    comes back as a device tensor: reading it is the caller's sync.
    """

    def step(params, opt_state, fc, att, labels, masks, top_words, lr, ss_prob,
             generator):
        def loss_of(p):
            if compute_dtype is not None:
                p = cast_tree(p, compute_dtype)
            lps, reason = model.forward(p, fc, att, labels, ss_prob=ss_prob,
                                        generator=generator, training=True)
            return crit(lps, labels, masks, reason, top_words)

        return grad_update(params, opt_state, tx, lr, loss_of)

    return step


def grad_update(params, opt_state, tx, lr, loss_of):
    """The gradient of ``loss_of(params)`` through the optimizer ``tx``,
    applied in place: -> (params, opt_state, loss as a device tensor)."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_of(tree_unflatten(params, live))
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    direction, opt_state = tx.update(tree_unflatten(params, grads), opt_state, params)
    return apply_updates(params, direction, lr), opt_state, loss.detach()


def device_batch(data, device, compute_dtype=None):
    """The loader's numpy batch dict -> (fc list, att list, labels, masks,
    top_words) on ``device``; features in the compute dtype."""
    def feat(x):
        t = torch.as_tensor(x, device=device)
        return t if compute_dtype is None else t.to(compute_dtype)

    return ([feat(x) for x in data["fc_feats_array"]],
            [feat(x) for x in data["att_feats_array"]],
            torch.as_tensor(data["labels"], device=device),
            torch.as_tensor(data["masks"], device=device),
            torch.as_tensor(data["top_words"], device=device))


def resume(opt, model, loader, rank, device, *, best=False, prefix="",
           with_opt_state=True):
    """-> (params, saved optimizer state or None, infos) of the checkpoint
    triple ``{prefix}..._{opt.load_model_id}_{rank}[-best]`` in
    opt.start_from, on ``device``; the loader's state restored. The
    optimizer file is read only ``with_opt_state``."""
    params_np, infos = load_checkpoint(opt.start_from, opt.load_model_id, rank,
                                       best=best, prefix=prefix)
    assert_arch_matches(opt, infos.get("opt", {}))
    params = params_from_jax(params_np)
    check_params(model, params)
    saved = (load_optimizer(opt.start_from, opt.load_model_id, rank, best=best,
                            prefix=prefix) if with_opt_state else None)
    opt_state = None if saved is None else opt_state_from_jax(saved, model)
    if "iterators" in infos:
        loader.restore_state(infos["iterators"], infos["split_image_id"],
                             infos.get("loader_rng"))
    to_dev = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
    if isinstance(opt_state, AdamState):
        opt_state = AdamState(opt_state.count, to_dev(opt_state.mu), to_dev(opt_state.nu))
    elif isinstance(opt_state, SgdState):
        opt_state = SgdState(to_dev(opt_state.trace))
    return to_dev(params), opt_state, infos


def state_fits(state, tx) -> bool:
    if tx.name == "adam":
        return isinstance(state, AdamState)
    return isinstance(state, SgdState) and (state.trace is None) == (not tx.momentum)


def train(opt, loader, *, rank: int = 0, max_iterations: Optional[int] = None,
          log_fn=print):
    """Run XE training on ``opt.device`` (CUDA unless "cpu"). Returns the
    infos dict (iter, epoch, histories, final params and optimizer state)."""
    device = resolve_device(opt.device)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length
    model = setup(opt)
    # the port's random stream (dropout, scheduled sampling); a resumed run
    # starts it from the seed, as it cannot continue the JAX key chain
    generator = torch.Generator(device=device).manual_seed(opt.seed + rank)

    crit = make_criterion(opt)
    tx = make_optimizer(opt)
    infos, opt_state = {}, None
    if opt.start_from is not None:
        params, opt_state, infos = resume(opt, model, loader, rank, device)
        if opt_state is not None and not state_fits(opt_state, tx):
            raise ValueError(
                f"the checkpoint's optimizer state {type(opt_state).__name__} does "
                f"not fit --optim {opt.optim} (momentum {opt.optim_momentum})")
    else:
        params = model.init_params(generator, device=device)
    if opt_state is None:
        opt_state = tx.init(params)

    iteration = infos.get("iter", 0)
    epoch = infos.get("epoch", 0)
    loss_history = dict(infos.get("loss_history", {}))
    lr_history = dict(infos.get("lr_history", {}))
    ss_prob_history = dict(infos.get("ss_prob_history", {}))

    compute_dtype = torch.bfloat16 if opt.dtype == "bfloat16" else None
    train_step = make_train_step(model, crit, tx, compute_dtype)
    lr, ss_prob = opt.optim_lr, 0.0
    update_lr_flag = True

    def schedule():
        nonlocal lr, ss_prob, update_lr_flag
        if update_lr_flag:
            lr = lr_for_epoch(opt, epoch, opt.optim_lr)
            ss_prob = ss_prob_for_epoch(opt, epoch)
            opt.current_lr, opt.ss_prob = lr, ss_prob
            update_lr_flag = False

    def dispatch():
        nonlocal params, opt_state
        data = loader.get_batch("train")
        batch = device_batch(data, device, compute_dtype)
        params, opt_state, loss = train_step(params, opt_state, *batch, lr, ss_prob,
                                             generator)
        return data, loss

    # --xe_overlap (default on): iteration k's epilogue fetches batch k+1 and
    # queues step k+1 on the device before loss k is read, so reading the
    # loss does not leave the device idle while the host dispatches. Fetch
    # order and numerics are the serial loop's.
    overlap = bool(opt.xe_overlap)
    pending = None
    while True:
        schedule()
        start = time.time()
        if pending is None:
            data, loss = dispatch()
        else:
            (data, loss), pending = pending, None
        if data["bounds"]["wrapped"]:
            epoch += 1
            update_lr_flag = True

        if iteration % opt.save_checkpoint_every == 0 and iteration > 0:
            raise NotImplementedError(
                f"iteration {iteration} is an eval / checkpoint boundary "
                f"(save_checkpoint_every {opt.save_checkpoint_every}): eval_split and "
                "checkpoint writing are not ported yet (ROADMAP.md queue 1, M6)")
        train_loss = elapsed = None
        if iteration % opt.losses_log_every == 0:
            train_loss = float(loss)
            elapsed = time.time() - start
            loss_history[iteration] = train_loss
            lr_history[iteration] = lr
            ss_prob_history[iteration] = ss_prob

        lr_k = lr  # iteration k's own lr; the epilogue may advance it
        more = (not (opt.max_epochs != -1 and epoch >= opt.max_epochs)
                and not (max_iterations is not None and iteration + 1 >= max_iterations))
        if overlap and more:
            schedule()
            pending = dispatch()
        if train_loss is None:
            train_loss = float(loss)  # waits for step k only
            elapsed = time.time() - start
        log_fn(f"rank {rank}, iter {iteration}, (epoch {epoch}), train loss: "
               f"{train_loss:.4f}, lr: {lr_k:.2e}, time: {elapsed:.3f}")
        iteration += 1
        if not more:
            break

    infos.update(iter=iteration, epoch=epoch, loss_history=loss_history,
                 lr_history=lr_history, ss_prob_history=ss_prob_history,
                 final_params=params, final_opt_state=opt_state)
    return infos
