"""Cross-entropy training loop.

Counterpart of ``recurrent_fusion_network_tpu/training/train_loop.py``:
``make_train_step`` (forward, the ensemble criterion, gradients, then the
clamp -> weight-decay -> Adam update) and ``train`` (per-epoch lr and
scheduled-sampling schedule, loss/lr/ss histories, the ``--xe_overlap``
order, periodic ``eval_split`` with best-by-CIDEr checkpoint triples, the
early stop after ``num_eval_no_improve`` stagnant evals, the SIGTERM save,
JSONL events, and resume from a triple either package wrote).

On a CUDA device the loader stages batches in page-locked memory and
``device_batch`` copies them on a side stream (``data/pinned.py``), so the
copy of batch k+1 runs while step k computes. ``train`` takes any loader
whose ``get_batch("train")`` returns the loader's batch dict. Not ported:
multi-device meshes (ROADMAP.md queue 1, M10), orbax checkpoints and the
trace window (M11).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import is_jax_key
from ..convert import (check_params, opt_state_from_jax, opt_state_to_jax, params_from_jax,
                       params_to_jax)
from ..data.pinned import device_batch
from ..device import resolve_device
from ..models import setup
from ..models.base import resolve_tied
from ..ops.initializers import tree_leaves, tree_map, tree_unflatten
from ..utils.logging import JsonlLogger
from .checkpoint import (assert_arch_matches, cast_tree, link_triple, load_checkpoint,
                         load_optimizer, save_checkpoint)
from .criterion import make_criterion
from .optim import (apply_updates, lr_for_epoch, make_optimizer, ss_prob_for_epoch,
                    state_fits, state_to)
from .preempt import PreemptGuard

# infos key of the port's random stream (the JAX package's is ``rng_key``,
# a JAX key the port neither writes nor reads)
RNG_KEY = "torch_rng_state"


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


def resume(opt, model, loader, rank, device, *, best=False, prefix="",
           with_opt_state=True):
    """-> (params, saved optimizer state or None, infos) of the checkpoint
    triple ``{prefix}..._{opt.load_model_id}_{rank}[-best]`` in
    opt.start_from, on ``device``; the loader's state restored. The
    optimizer file is read only ``with_opt_state``. The caller restores its
    generator from ``infos[RNG_KEY]`` where it continues the run."""
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
    if opt_state is not None:
        opt_state = state_to(opt_state, device)
    return tree_map(lambda x: x.to(device), params), opt_state, infos


def restore_generator(generator, infos) -> None:
    """Continue the port's random stream where a port-written triple left
    it (a JAX-written one has none: the stream starts from the seed)."""
    if RNG_KEY in infos:
        generator.set_state(torch.from_numpy(np.array(infos[RNG_KEY], np.uint8)))


def snapshot_opt(opt) -> dict:
    """The opt dict a checkpoint keeps: the keys the JAX package's options
    have (``config.is_jax_key``; the JAX eval adopts every saved key it
    does not override), tied_att_keys resolved to 0 / 1 as the JAX
    package's loader compares it with its CLI's."""
    saved = {k: v for k, v in vars(opt).items() if is_jax_key(k)}
    saved["tied_att_keys"] = int(resolve_tied(opt))
    return saved


def to_host(params, opt_state, opt):
    """(params, optimizer chain) as the numpy trees a triple holds: the
    one copy from the device that the triples of a boundary share."""
    return params_to_jax(params), opt_state_to_jax(opt_state, opt)


def write_triple(opt, rank, host, infos, *, best, prefix=""):
    """Write the triple of one tag from a ``to_host`` copy."""
    params_np, chain = host
    save_checkpoint(opt.checkpoint_path, opt.id, rank, params=params_np, opt_state=chain,
                    infos=infos, best=best, prefix=prefix)


def save_triple(opt, rank, params, opt_state, infos, *, best, prefix=""):
    write_triple(opt, rank, to_host(params, opt_state, opt), infos, best=best, prefix=prefix)


class Boundaries:
    """The eval / checkpoint boundaries both loops share (JAX
    train_loop.py:277-341, train_rl_loop.py:407-470): ``eval_split`` on val,
    the score (CIDEr under --language_eval, else -loss), the best score and
    the count of evals since it (``num_period_best``; the run stops at
    ``num_eval_no_improve``), and the ``prefix``-ed triples with their
    infos. The state resumes from a checkpoint's infos."""

    def __init__(self, opt, rank, infos, *, prefix="", resume_count=True):
        self.opt, self.rank, self.prefix = opt, rank, prefix
        self.val_result_history = dict(infos.get("val_result_history", {}))
        self.best_val_score = infos.get("best_val_score") if opt.load_best_score else None
        # a JAX fleet's triple counts under no_improve
        count = infos.get("num_period_best", infos.get("no_improve", 0))
        self.num_period_best = int(count) if resume_count else 0
        self.current_score = 0.0

    def evaluate(self, model, params, loader, iteration):
        """-> (val loss, lang_stats or None, whether the score is a new
        best, seconds)."""
        from .eval_split import eval_split

        t0 = time.time()
        val_loss, predictions, lang_stats = eval_split(model, params, loader, self.opt,
                                                       split="val", rank=self.rank)
        self.val_result_history[iteration] = {
            "loss": val_loss, "lang_stats": lang_stats, "predictions": predictions}
        self.current_score = (lang_stats["CIDEr"] if self.opt.language_eval and lang_stats
                              else -val_loss)
        best = self.best_val_score is None or self.current_score > self.best_val_score
        if best:
            self.best_val_score, self.num_period_best = self.current_score, 1
        else:
            self.num_period_best += 1
        return val_loss, lang_stats, best, time.time() - t0

    def stagnant(self) -> bool:
        return self.num_period_best >= self.opt.num_eval_no_improve

    def snapshot(self, loader, generator, iteration, epoch, **histories) -> dict:
        """The infos of a triple taken after step ``iteration`` (loader,
        generator and params post-step), so ``iter`` records the next step
        to run."""
        return {
            "iter": iteration + 1,
            "epoch": epoch,
            "iterators": dict(loader.iterators),
            "split_image_id": {s: list(v) for s, v in loader.split_image_id.items()},
            "loader_rng": dict(loader.rng_states),
            "best_val_score": self.best_val_score,
            "opt": snapshot_opt(self.opt),
            "val_result_history": self.val_result_history,
            **histories,
            "num_period_best": self.num_period_best,
            RNG_KEY: generator.get_state().numpy(),
            "vocab": loader.get_vocab(),
        }

    def write(self, host, infos, *, best, rolling=False) -> None:
        """The ``prefix``-ed triple of one tag from a ``to_host`` copy; with
        ``best`` and ``rolling`` both tags, the rolling one written and the
        best one hard-linked to it (the same bytes)."""
        write_triple(self.opt, self.rank, host, infos, best=best and not rolling,
                     prefix=self.prefix)
        if best and rolling:
            o = self.opt
            link_triple(o.checkpoint_path, o.id, self.rank, o.checkpoint_path, o.id,
                        src_best=False, dst_best=True, src_prefix=self.prefix,
                        dst_prefix=self.prefix)

    def save(self, params, opt_state, infos, *, best=False) -> None:
        """The triple and, at a new best, the best one beside it: one copy
        of params and moments off the device, written once."""
        self.write(to_host(params, opt_state, self.opt), infos, best=best, rolling=True)


def start_state(opt, model, tx, loader, rank, device):
    """Rank ``rank``'s starting point of an XE run: -> (params, opt_state,
    generator, infos). A fresh run draws the params from the rank's
    generator (seed + rank; it then drives dropout and scheduled
    sampling); with ``opt.start_from`` the rank's triple is resumed, its
    random stream and the loader's state with it."""
    generator = torch.Generator(device=device).manual_seed(opt.seed + rank)
    infos, opt_state = {}, None
    if opt.start_from is not None:
        params, opt_state, infos = resume(opt, model, loader, rank, device)
        restore_generator(generator, infos)
        if opt_state is not None and not state_fits(opt_state, tx):
            raise ValueError(
                f"the checkpoint's optimizer state {type(opt_state).__name__} does "
                f"not fit --optim {opt.optim} (momentum {opt.optim_momentum})")
    else:
        params = model.init_params(generator, device=device)
    if opt_state is None:
        opt_state = tx.init(params)
    return params, opt_state, generator, infos


def train(opt, loader, *, rank: int = 0, max_iterations: Optional[int] = None,
          log_fn=print):
    """Run XE training on ``opt.device`` (CUDA unless "cpu"). Returns the
    infos dict of the last checkpoint snapshot (or {}) updated with iter,
    epoch, the histories, final_params and final_opt_state."""
    device = resolve_device(opt.device)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length
    model = setup(opt)
    crit = make_criterion(opt)
    tx = make_optimizer(opt)
    params, opt_state, generator, infos = start_state(opt, model, tx, loader, rank, device)

    iteration = infos.get("iter", 0)
    epoch = infos.get("epoch", 0)
    loss_history = dict(infos.get("loss_history", {}))
    lr_history = dict(infos.get("lr_history", {}))
    ss_prob_history = dict(infos.get("ss_prob_history", {}))
    bounds = Boundaries(opt, rank, infos)

    compute_dtype = torch.bfloat16 if opt.dtype == "bfloat16" else None
    train_step = make_train_step(model, crit, tx, compute_dtype)
    jlog = JsonlLogger(opt.json_log or None)
    guard = PreemptGuard.from_opt(opt)
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

    def snapshot_infos():
        return bounds.snapshot(loader, generator, iteration, epoch, loss_history=loss_history,
                               lr_history=lr_history, ss_prob_history=ss_prob_history)

    # --xe_overlap (default on): iteration k's epilogue fetches batch k+1 and
    # queues step k+1 on the device before loss k is read, so reading the
    # loss does not leave the device idle while the host dispatches. Fetch
    # order and numerics are the serial loop's; the continuation verdict
    # (eval early stop, SIGTERM, the limits) comes first, so a snapshot
    # never sees a prefetched batch.
    overlap = bool(opt.xe_overlap)
    pending = None
    try:
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

            stop = False
            train_loss = elapsed = None
            is_eval = iteration % opt.save_checkpoint_every == 0 and iteration > 0
            is_log = iteration % opt.losses_log_every == 0
            if is_eval or is_log:
                train_loss = float(loss)
                elapsed = time.time() - start
            if is_log:
                loss_history[iteration] = train_loss
                lr_history[iteration] = lr
                ss_prob_history[iteration] = ss_prob
                jlog.log(event="train", iter=iteration, epoch=epoch, loss=train_loss, lr=lr,
                         ss_prob=ss_prob, seconds=elapsed)
            if is_eval:
                val_loss, lang_stats, best, eval_s = bounds.evaluate(model, params, loader,
                                                                     iteration)
                t_save = time.time()
                infos = snapshot_infos()
                bounds.save(params, opt_state, infos, best=best)
                if best:
                    log_fn(f"model saved to {opt.checkpoint_path} "
                           f"(CIDEr {bounds.current_score:.3f})")
                jlog.log(event="val", iter=iteration, loss=val_loss, seconds=eval_s,
                         save_seconds=time.time() - t_save, best=best, **(lang_stats or {}))
                if bounds.stagnant():
                    log_fn("no improvement, exit")
                    stop = True

            if not stop and guard.sync():
                # SIGTERM: save at this boundary (post-step; resume replays
                # nothing) and exit inside the preemption grace window
                infos = snapshot_infos()
                bounds.save(params, opt_state, infos)
                log_fn(f"rank {rank}: preempted — checkpoint saved "
                       f"(resumes at iter {iteration + 1})")
                stop = True

            lr_k = lr  # iteration k's own lr; the epilogue may advance it
            more = (not stop
                    and not (opt.max_epochs != -1 and epoch >= opt.max_epochs)
                    and not (max_iterations is not None and iteration + 1 >= max_iterations))
            if overlap and more:
                schedule()
                pending = dispatch()
            if train_loss is None:
                train_loss = float(loss)  # waits for step k only
                elapsed = time.time() - start
            if not stop:
                log_fn(f"rank {rank}, iter {iteration}, (epoch {epoch}), train loss: "
                       f"{train_loss:.4f}, lr: {lr_k:.2e}, "
                       f"current cider: {bounds.current_score:.3f}, "
                       f"time: {elapsed:.3f}")
            iteration += 1
            if stop or not more:
                break
    finally:
        jlog.close()
        guard.close()

    infos = dict(infos)
    infos.update(iter=iteration, epoch=epoch, loss_history=loss_history,
                 lr_history=lr_history, ss_prob_history=ss_prob_history,
                 val_result_history=bounds.val_result_history,
                 best_val_score=bounds.best_val_score, final_params=params,
                 final_opt_state=opt_state)
    return infos
