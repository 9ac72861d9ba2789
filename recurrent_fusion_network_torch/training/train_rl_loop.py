"""Self-critical (SCST) training.

Counterpart of ``recurrent_fusion_network_tpu/training/train_rl_loop.py``
(the reference's main_rl.py + train_rl.py). Each iteration:

  1. one ROLLOUT without gradients (``make_rollout_fn``): encode once, then
     the multinomial rollout and its greedy baseline as one decode over 2B
     stacked lanes;
  2. host-side CIDEr-D (± BLEU-4) rewards on the sampled ids, with the
     greedy rollout's reward as the baseline (``rewards/self_critical.py``);
  3. one GRADIENT step (``make_rl_step``) that re-evaluates the sampled
     sequence with teacher forcing: the decoder is autoregressive, so
     feeding the sampled tokens gives the rollout's per-step distributions
     at every step the SCST mask keeps, then the policy-gradient criterion
     with the entropy term (optionally PPO) and the clamp -> weight decay ->
     Adam update of the XE step.

Rollout and re-evaluation run in f32 without dropout (``training=False``),
whatever ``--dtype`` says, as the JAX package does: the evaluated policy
must be the sampled one, and dropout draws cannot be shared between the two
passes. With ``--use_ppo``, each of the ppo_k extra steps re-evaluates the
ratio against the frozen rollout log-probs with the current parameters.

The rollout draws from a ``torch.Generator`` seeded with seed + rank. A
``--rl_resume`` from a port-written ``rl_`` triple continues that stream
(its ``torch_rng_state``); from a JAX-written one it restarts from the
seed, as the JAX run's key chain (its ``rng_key``) cannot be continued.

Every ``save_checkpoint_every`` iterations: ``eval_split`` on val, the
``rl_``-prefixed triples (non-best, and best by CIDEr, measured against the
warm start's score under ``--load_best_score``), the early stop after
``num_eval_no_improve`` stagnant evals; SIGTERM saves the ``rl_`` triple at
the next boundary. On a CUDA device batches are staged in page-locked
memory and copied on a side stream (``data/pinned.py``), so under
``--rl_overlap 1`` the copy of batch k+1 runs while step k computes.

The multi-seed SCST fleet runs these same functions seed by seed
(``multi_seed.py``). With --spice_weight > 0 the reward adds SPICE through
one hook built at the start (``metrics/spice.py::make_spice_fn``,
--spice_backend approx | http). Checkpoints go through
``checkpoint.backend(opt)`` and --profile_steps traces a window of
iterations, as in the XE loop. ``train_rl`` takes any loader whose
``get_batch("train")`` returns the loader's batch dict, with ``gts``.

Data parallelism (``mesh``; JAX train_rl_loop.py:258-291, 318, 364-369,
426-452): each rank rolls out and scores its own rows (CIDEr-D, and SPICE
at --spice_weight > 0), the rollout's draws made at the global batch's
size (``RowShard``); the step's gradients and loss are averaged over the
ranks as in the XE loop, the logged mean reward too (on the logged
iterations only; the console line shows the rank's own rows, as the JAX
loop's does), and the eval, the early stop and the saves work as there.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..decoding.engine import make_step_fn
from ..decoding.sample import sample
from ..device import resolve_device
from ..metrics.spice import make_spice_fn
from ..models import setup
from ..ops.initializers import tree_map
from ..rewards.cider_d import CiderD
from ..rewards.self_critical import compute_reward
from ..ops.cells import RowShard
from ..parallel.distributed import all_hosts_agree, host_mean
from ..parallel.mesh import MP_RL
from ..utils.logging import JsonlLogger
from ..utils.profiling import TraceWindow, span
from .checkpoint import backend
from .criterion import make_rl_criterion
from .optim import lr_for_epoch, make_optimizer, state_fits
from .preempt import PreemptGuard
from .train_loop import (Boundaries, device_batch, grad_update, quiet, restore_generator,
                         resume)


def make_rollout_fn(model):
    """-> rollout(params, fc, att, generator) -> (sampled seq, greedy seq),
    each (B, L) int64 on the params' device, 0 after EOS.

    Rows 0..B-1 of one decode over 2B lanes draw from the model's
    distribution, rows B..2B-1 take its argmax: the two rollouts share every
    step's weight reads and run the matmuls at double width. Nothing is
    read back to the host. A data-parallel rank's ``RowShard`` draws for
    its rows of both halves of the global 2B lanes.
    """

    @torch.no_grad()
    def rollout(params, fc, att, generator):
        if isinstance(generator, RowShard):
            generator = generator.blocked(2)
        enc = model.encode(params, fc, att)
        double = lambda x: torch.cat([x, x], dim=0)  # noqa: E731
        state2, mem2 = tree_map(double, enc.state), tree_map(double, enc.memory)
        B = fc[0].shape[0]
        greedy_mask = torch.arange(2 * B, device=fc[0].device) >= B
        out = sample(make_step_fn(model, params, mem2), state2, 2 * B, model.seq_length,
                     model.vocab_size + 1, greedy_mask=greedy_mask, generator=generator)
        return out.seq[:B], out.seq[B:]

    return rollout


def seq_to_inputs(seq):
    """(B, L) sampled ids -> (B, L+2) teacher-forcing input: BOS, the ids,
    a trailing 0."""
    B, L = seq.shape
    full = seq.new_zeros((B, L + 2))
    full[:, 1:L + 1] = seq
    return full


def make_rl_step(model, rl_crit, tx, mesh=None):
    """-> (step, old_logprobs).

    step(params, opt_state, fc, att, seq, reward, top_words, lr,
    sample_logprobs_old) -> (params, opt_state, loss): teacher-forced
    ``forward`` on the sampled ids, the sampled tokens' log-probs, the SCST
    criterion, its gradient and the optimizer update, in place on params
    and opt_state. The loss comes back as a device tensor; with a
    data-parallel ``mesh`` the gradients and the loss are the ranks' means.
    old_logprobs(params, fc, att, seq): the sampled tokens' log-probs under
    ``params``, without gradients (PPO's frozen log-probs).
    """

    def sampled_logprobs(lps, seq):
        return lps[:, :seq.shape[1]].gather(2, seq[..., None])[..., 0]

    def step(params, opt_state, fc, att, seq, reward, top_words, lr,
             sample_logprobs_old):
        def loss_of(p):
            lps, reason = model.forward(p, fc, att, seq_to_inputs(seq))
            return rl_crit(sampled_logprobs(lps, seq), seq, reward, lps, reason,
                           top_words, sample_logprobs_old)

        return grad_update(params, opt_state, tx, lr, loss_of, mesh)

    @torch.no_grad()
    def old_logprobs(params, fc, att, seq):
        lps, _ = model.forward(params, fc, att, seq_to_inputs(seq))
        return sampled_logprobs(lps, seq)

    return step, old_logprobs


def is_rl_resume(opt) -> bool:
    """Whether the run resumes its own ``rl_`` triple (--rl_resume with
    --start_from) rather than warm-starting from the XE best one."""
    return bool(opt.rl_resume) and opt.start_from is not None


def start_rl_state(opt, model, tx, loader, rank, device, log_fn=print, *,
                   restore_loader=True):
    """Rank ``rank``'s starting point of an SCST run: -> (params, opt_state,
    generator, infos, rl_lr_base). With ``opt.start_from``: a warm start
    from the rank's XE best triple (a fresh random stream, seed + rank) or,
    under --rl_resume, a resume from its ``rl_`` triple (stream, rl_lr_base
    and moments adopted); --load_lr derives the base from the XE lr history
    and adopts the moments. Without it the params are drawn from the
    rank's generator. With ``restore_loader`` the triple's loader state is
    restored."""
    generator = torch.Generator(device=device).manual_seed(opt.seed + rank)
    rl_resume = is_rl_resume(opt)
    infos, saved_state = {}, None
    if opt.start_from is not None:
        params, saved_state, infos = resume(
            opt, model, loader, rank, device, best=not rl_resume,
            prefix="rl_" if rl_resume else "", with_opt_state=bool(opt.load_lr or rl_resume),
            restore_loader=restore_loader)
        if rl_resume:  # a warm start keeps its own fresh stream
            restore_generator(generator, infos)
    else:
        params = model.init_params(generator, device=device)

    rl_lr_base = opt.optim_rl_lr
    lr_history = infos.get("lr_history", {})
    if rl_resume:
        if "rl_lr_base" in infos:
            rl_lr_base = infos["rl_lr_base"]
        else:
            # the lr history holds the XE warm start's values too, so it
            # cannot give the base back
            log_fn("warning: rl checkpoint predates rl_lr_base; the original base is "
                   "not recoverable from the (XE-contaminated) lr history; resuming "
                   f"with --optim_rl_lr {rl_lr_base:.2e}")
    elif opt.load_lr and lr_history:
        rl_lr_base = min(lr_history.values()) / opt.optim_rl_lr_ratio

    opt_state = None
    if saved_state is not None:
        if state_fits(saved_state, tx):
            opt_state = saved_state
        else:
            log_fn(f"warning: the checkpoint's optimizer state {type(saved_state).__name__} "
                   f"does not fit --optim {opt.optim}; re-initialized")
    if opt_state is None:
        opt_state = tx.init(params)
    return params, opt_state, generator, infos, rl_lr_base


def train_rl(opt, loader, cider_scorer: CiderD, *, rank: int = 0,
             max_iterations: Optional[int] = None, log_fn=print, mesh=None):
    """Run SCST training on ``opt.device`` (CUDA unless "cpu"). Returns the
    infos dict of the last checkpoint snapshot (or of the warm start)
    updated with iter, epoch, loss_history (the mean reward per logged
    iteration, as the JAX package records it), train_loss_history (the
    criterion's value), lr_history, val_result_history, rl_lr_base,
    final_params and final_opt_state.

    With ``opt.start_from``: a warm start from the XE best triple
    (``model_{id}_{rank}-best.pkl`` ...) or, with ``--rl_resume``, a resume
    from the RL run's own ``rl_`` triple (its ``rl_lr_base``, optimizer
    moments, early-stop count and random stream adopted). ``--load_lr``
    sets the lr base to min(lr history) / optim_rl_lr_ratio and adopts the
    checkpoint's optimizer state. ``mesh``: this process is one rank of a
    data-parallel run, its loader sharded over the ranks.
    """
    if mesh is not None and mesh.mp > 1:  # JAX main_rl.py:26-29
        raise ValueError(MP_RL)
    device = resolve_device(opt.device)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length
    model = setup(opt)
    rl_crit = make_rl_criterion(opt)
    tx = make_optimizer(opt)
    lead = mesh is None or mesh.rank == 0
    log_fn = log_fn if lead else quiet
    params, opt_state, generator, infos, rl_lr_base = start_rl_state(
        opt, model, tx, loader, rank, device, log_fn)
    if mesh is not None:
        mesh.replicate(params, opt_state)
    draws = generator if mesh is None else mesh.draws(generator)

    iteration = infos.get("iter", 0)
    epoch = infos.get("epoch", 0)
    loss_history = dict(infos.get("loss_history", {}))
    lr_history = dict(infos.get("lr_history", {}))
    train_loss_history = {}
    # a warm start measures against the XE best score but counts afresh
    bounds = Boundaries(opt, rank, infos, prefix="rl_", resume_count=is_rl_resume(opt),
                        mesh=mesh)
    rollout_fn = make_rollout_fn(model)
    rl_step, old_logprobs_fn = make_rl_step(model, rl_crit, tx, mesh)
    jlog = JsonlLogger((opt.json_log or None) if lead else None)
    guard = PreemptGuard.from_opt(opt)
    trace = TraceWindow.from_opt(opt)
    # one SPICE scorer for the run (JAX train_rl_loop.py:232-238)
    spice_fn = make_spice_fn(opt, loader.get_vocab()) if opt.spice_weight > 0 else None

    def fetch_and_roll_out():
        data = loader.get_batch("train")
        fc, att, _, _, top_words = device_batch(data, device)
        with span("rl.rollout"):
            seq, greedy_seq = rollout_fn(params, fc, att, draws)
        return data, fc, att, top_words, seq, greedy_seq

    def snapshot_infos():
        return bounds.snapshot(loader, generator, iteration, epoch, loss_history=loss_history,
                               lr_history=lr_history, rl_lr_base=rl_lr_base)

    # --rl_overlap (default on): after step k is queued, batch k+1 is
    # fetched and rollout k+1 queued on step k's params before loss k is
    # read, so the host dispatches the rollout while the device runs the
    # step. Draw order, fetch order and numerics are the serial loop's; the
    # continuation verdict comes first, so a snapshot never sees a
    # prefetched batch.
    overlap = bool(opt.rl_overlap)
    update_lr_flag = True
    lr = rl_lr_base
    pending = None
    try:
        while True:
            trace.tick(iteration)
            if update_lr_flag:
                lr = lr_for_epoch(opt, epoch, rl_lr_base)
                opt.current_lr = lr
                update_lr_flag = False

            start = time.time()
            if pending is None:
                data, fc, att, top_words, seq, greedy_seq = fetch_and_roll_out()
            else:
                (data, fc, att, top_words, seq, greedy_seq), pending = pending, None
            with span("rl.rollout_read"):
                seq_host, greedy_host = seq.cpu().numpy(), greedy_seq.cpu().numpy()
            rewards = compute_reward(
                cider_scorer, seq_host, greedy_host, data["gts"],
                use_baseline=bool(opt.use_baseline), cider_weight=opt.cider_weight,
                bleu4_weight=opt.bleu4_weight, spice_weight=opt.spice_weight,
                spice_fn=spice_fn)
            reward_dev = torch.as_tensor(rewards, dtype=torch.float32, device=device)

            with span("rl.dispatch"):
                if opt.use_ppo:
                    slp_old = old_logprobs_fn(params, fc, att, seq)
                    for _ in range(opt.ppo_k + 1):
                        params, opt_state, loss = rl_step(params, opt_state, fc, att, seq,
                                                          reward_dev, top_words, lr, slp_old)
                else:  # the criterion reads no old log-probs without PPO
                    params, opt_state, loss = rl_step(params, opt_state, fc, att, seq,
                                                      reward_dev, top_words, lr,
                                                      torch.zeros_like(reward_dev))

            if data["bounds"]["wrapped"]:
                epoch += 1
                update_lr_flag = True
            avg_reward = float(np.mean(rewards[:, 0]))  # this rank's rows (the console's)
            is_log = iteration % opt.losses_log_every == 0
            if is_log:
                # the logged mean is the global one (equal shares of rows);
                # every rank takes this branch on the same iterations
                logged_reward = avg_reward if mesh is None else host_mean(avg_reward)
                loss_history[iteration] = logged_reward
                lr_history[iteration] = lr

            stop = False
            train_loss = elapsed = None
            if iteration % opt.save_checkpoint_every == 0 and iteration > 0:
                train_loss = float(loss)  # the eval blocks anyway
                elapsed = time.time() - start
                val_loss, lang_stats, best, eval_s = bounds.evaluate(model, params, loader,
                                                                     iteration)
                t_save = time.time()
                infos = snapshot_infos()
                bounds.save(params, opt_state, infos, best=best)
                if best:
                    log_fn(f"rl model saved (CIDEr {bounds.current_score:.3f})")
                jlog.log(event="rl_val", iter=iteration, loss=val_loss, seconds=eval_s,
                         save_seconds=time.time() - t_save, best=best, **(lang_stats or {}))
                if all_hosts_agree(bounds.stagnant()):
                    log_fn("no improvement, exit")
                    stop = True

            if not stop and guard.sync():
                infos = snapshot_infos()
                bounds.save(params, opt_state, infos)
                log_fn(f"rank {rank}: preempted — rl checkpoint saved "
                       f"(resumes at iter {iteration + 1})")
                stop = True

            more = (not stop
                    and not (opt.max_epochs != -1 and epoch >= opt.max_epochs)
                    and not (max_iterations is not None and iteration + 1 >= max_iterations))
            if overlap and more:
                pending = fetch_and_roll_out()
            if train_loss is None:
                train_loss = float(loss)  # waits for step k only
                elapsed = time.time() - start
            if is_log:
                train_loss_history[iteration] = train_loss
                jlog.log(event="rl_train", iter=iteration, epoch=epoch, avg_reward=logged_reward,
                         loss=train_loss, lr=lr, seconds=elapsed)
            if not stop:
                log_fn(f"rank {rank}, iter {iteration}, (epoch {epoch}), avg_reward: "
                       f"{avg_reward:.3f}, train_loss: {train_loss:.4f}, lr: {lr:.2e}, "
                       f"time: {elapsed:.3f}")
            iteration += 1
            if stop or not more:
                break
    finally:
        trace.close()
        jlog.close()
        guard.close()
    backend(opt).wait_until_finished()  # the last async save lands before the run ends

    infos = dict(infos)
    infos.update(iter=iteration, epoch=epoch, loss_history=loss_history,
                 lr_history=lr_history, train_loss_history=train_loss_history,
                 val_result_history=bounds.val_result_history,
                 best_val_score=bounds.best_val_score, rl_lr_base=rl_lr_base,
                 final_params=params, final_opt_state=opt_state)
    return infos
