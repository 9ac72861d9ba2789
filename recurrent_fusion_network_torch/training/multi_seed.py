"""Multi-seed fleets: XE and SCST training of S seeds in one process.

Counterpart of ``recurrent_fusion_network_tpu/training/multi_seed.py``
(``train_multi_seed``, ``train_multi_seed_rl``). The reference trains its
ensemble's members as one single-GPU job per seed
(train_recurrent_fusion_model.sh:7-30, train_recurrent_fusion_model_rl.sh:
16-36); the JAX package vmaps the step over a seed axis. Here the fleet
holds S per-seed states (params, optimizer state, ``torch.Generator``
seeded with seed + r) on one device, copies each batch to the device once,
and then runs, seed by seed, the very functions of the solo loops:
``train_loop.make_train_step`` for XE, ``train_rl_loop.make_rollout_fn``
and ``make_rl_step`` for SCST. So seed r follows solo ``train(rank=r)`` /
``train_rl(rank=r)`` exactly, and one seed's activations are freed before
the next seed's step: the device holds S models' params and moments plus
one step's activations. (``torch.func.vmap`` does not fit: the attention
kernels are ctypes launches behind an ``autograd.Function`` without a vmap
rule, and dropout draws from explicit generators.)

Each seed keeps the solo loop's boundary state (``train_loop.Boundaries``):
best-by-validation with its ``-best`` triple written at improvement time,
and rolling triples under the solo ``model_{id}_{r}`` naming, so the fleet
resumes as a fleet (``--start_from``; ``--rl_resume`` for SCST) from the
port's triples (per-seed ``torch_rng_state``) or the JAX package's, and
any seed resumes solo. At a boundary each seed's params and moments cross
from the device once and are written once: an improving seed's ``-best``
names are hard links to its rolling files. Every seed's eval draws the val
captions from the state its solo run would find. The fleet stops early once every seed is stagnant
(``num_eval_no_improve``), and saves its rolling triples at SIGTERM
(``PreemptGuard``). An SCST seed warm-started from an XE ``-best`` that
never beats its warm-start score ships that triple's weights and moments
as its ``rl_``-best, so the ``rl_`` ensemble is complete. (The JAX SCST
fleet counts a warm start's iterations from 0; the port's, as both solo
loops, from the XE triple's ``iter``.)

Not ported: the fleet over a device mesh and multi-host seed ownership
(ROADMAP.md queue 1, M10), orbax fleets (M11), SPICE rewards (raises).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..data.pinned import device_batch
from ..device import resolve_device
from ..models import setup
from ..rewards.self_critical import check_spice_weight, compute_reward
from ..utils.logging import JsonlLogger
from .checkpoint import has_checkpoint, link_triple, save_infos
from .criterion import make_criterion, make_rl_criterion
from .optim import lr_for_epoch, make_optimizer, ss_prob_for_epoch
from .preempt import PreemptGuard
from .train_loop import Boundaries, make_train_step, start_state, to_host
from .train_rl_loop import is_rl_resume, make_rl_step, make_rollout_fn, start_rl_state


class Seed:
    """One fleet member's state: rank, params, optimizer state, random
    stream, boundary state and histories (the SCST fleet's lr base and lr
    history are its own per seed)."""

    def __init__(self, rank, params, opt_state, generator, bounds, infos, rl_lr_base=None):
        self.rank, self.params, self.opt_state = rank, params, opt_state
        self.generator, self.bounds = generator, bounds
        self.loss_history = dict(infos.get("loss_history", {}))
        self.lr_history = dict(infos.get("lr_history", {}))
        self.train_loss_history = {}
        self.rl_lr_base = self.lr = rl_lr_base
        self.best_written = False  # a -best triple written by this run
        self.ship_xe = False  # ships the XE best triple if it never improves


class Fleet:
    """What the XE and SCST fleets share: the per-seed boundary (eval, the
    rolling triple and, at an improvement, the -best one: one host copy,
    written once), the early-stop verdict and the epilogue eval."""

    def __init__(self, opt, model, loader, seeds, jlog, log_fn, save):
        self.opt, self.model, self.loader, self.seeds = opt, model, loader, seeds
        self.jlog, self.log_fn, self.save = jlog, log_fn, save

    def snapshot(self, seed, iteration, epoch, **histories):
        infos = seed.bounds.snapshot(self.loader, seed.generator, iteration, epoch,
                                     loss_history=seed.loss_history, **histories)
        infos["no_improve"] = seed.bounds.num_period_best  # the JAX fleet's key
        return infos

    def evaluate(self, at_iter, last_step, epoch, histories, *, rolling):
        """Every seed's val eval at the params after step ``last_step``
        (recorded under ``at_iter``); with ``rolling`` its rolling triple,
        and where it improved its -best one (a hard link to the rolling
        files, or written itself without ``rolling``). -> whether every
        seed is stagnant."""
        eval_s = save_s = 0.0
        scores = []
        # every seed's eval draws the val captions (the loss's labels) from
        # the state its solo run would find
        val_rng = self.loader.rng_states["val"]
        for seed in self.seeds:
            self.loader.rng_states["val"] = val_rng
            _, _, best, secs = seed.bounds.evaluate(self.model, seed.params, self.loader,
                                                    at_iter)
            eval_s += secs
            scores.append(seed.bounds.best_val_score)
            if not self.save or not (best or rolling):
                continue
            t0 = time.time()
            seed.bounds.write(to_host(seed.params, seed.opt_state, self.opt),
                              self.snapshot(seed, last_step, epoch, **histories(seed)),
                              best=best, rolling=rolling)
            seed.best_written = seed.best_written or best
            save_s += time.time() - t0
        self.log_fn(f"iter {at_iter} fleet val scores: "
                    + " ".join("-" if s is None else f"{s:.3f}" for s in scores))
        self.jlog.log(event="fleet_val", iter=at_iter, scores=scores,
                      current=[s.bounds.current_score for s in self.seeds],
                      metrics=[s.bounds.val_result_history[at_iter]["lang_stats"]
                               for s in self.seeds],
                      seconds=eval_s, save_seconds=save_s)
        return all(s.bounds.stagnant() for s in self.seeds)

    def end_of_iteration(self, guard, iteration, epoch, histories, max_iterations):
        """After step ``iteration``: the boundary when it is due (evals,
        triples, the early-stop verdict) and the SIGTERM check, which saves
        the rolling triples (unless the boundary just did) and ends the run
        without the epilogue's eval. -> (whether to go on, preempted)."""
        stop = rolled = False
        if iteration % self.opt.save_checkpoint_every == 0 and iteration > 0:
            stop = self.evaluate(iteration, iteration, epoch, histories, rolling=True)
            rolled = self.save
            if stop:
                self.log_fn("no improvement, exit")
        if stop or not guard.sync():
            return not stop and _more(self.opt, epoch, iteration, max_iterations), False
        if self.save and not rolled:
            for seed in self.seeds:
                seed.bounds.write(to_host(seed.params, seed.opt_state, self.opt),
                                  self.snapshot(seed, iteration, epoch, **histories(seed)),
                                  best=False)
        self.log_fn(f"preempted — rolling per-seed triples saved (resume at iter "
                    f"{iteration + 1})")
        return False, True

    def epilogue(self, iteration, epoch, histories, preempted, eval_at_end):
        """The final eval (unless preempted): it gives every seed a scored
        -best triple."""
        if preempted:
            return
        if eval_at_end or (self.save and any(s.bounds.best_val_score is None
                                             for s in self.seeds)):
            self.evaluate(iteration, iteration - 1, epoch, histories, rolling=False)

    def result(self, iteration, epoch, preempted, **extra):
        return dict(iter=iteration, epoch=epoch, model=self.model, preempted=preempted,
                    params=[s.params for s in self.seeds],
                    opt_states=[s.opt_state for s in self.seeds],
                    loss_histories=[s.loss_history for s in self.seeds],
                    val_histories=[s.bounds.val_result_history for s in self.seeds],
                    cider_per_seed=[s.bounds.best_val_score for s in self.seeds], **extra)


def _more(opt, epoch, iteration, max_iterations):
    return (not (opt.max_epochs != -1 and epoch >= opt.max_epochs)
            and not (max_iterations is not None and iteration + 1 >= max_iterations))


def train_multi_seed(opt, loader, n_seeds: int, *, max_iterations: Optional[int] = None,
                     eval_at_end: bool = True, save: bool = True, log_fn=print):
    """Train an XE fleet of ``n_seeds`` seeds on ``opt.device`` (CUDA
    unless "cpu"). Seed r starts as solo ``train(rank=r)`` does: drawn from
    the generator seeded with opt.seed + r, or with ``opt.start_from``
    resumed from its rolling triple ``model_{load_model_id}_{r}``. Returns
    a dict: iter, epoch, model, preempted, and per seed params, opt_states,
    loss_histories, val_histories, cider_per_seed (the best score), with
    the shared lr_history and ss_prob_history."""
    device = resolve_device(opt.device)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length
    model = setup(opt)
    crit, tx = make_criterion(opt), make_optimizer(opt)
    seeds = []
    for r in range(n_seeds):
        params, opt_state, generator, infos = start_state(opt, model, tx, loader, r, device)
        seeds.append(Seed(r, params, opt_state, generator, Boundaries(opt, r, infos), infos))
        if r == 0:
            infos0 = infos
    iteration, epoch = infos0.get("iter", 0), infos0.get("epoch", 0)
    lr_history = seeds[0].lr_history  # one schedule for every seed
    ss_prob_history = dict(infos0.get("ss_prob_history", {}))

    def histories(_seed):
        return dict(lr_history=lr_history, ss_prob_history=ss_prob_history)

    compute_dtype = torch.bfloat16 if opt.dtype == "bfloat16" else None
    train_step = make_train_step(model, crit, tx, compute_dtype)
    jlog = JsonlLogger(opt.json_log or None)
    guard = PreemptGuard.from_opt(opt)
    fleet = Fleet(opt, model, loader, seeds, jlog, log_fn, save)
    lr, ss_prob, update_lr_flag, preempted = opt.optim_lr, 0.0, True, False
    try:
        while True:
            if update_lr_flag:
                lr, ss_prob = lr_for_epoch(opt, epoch, opt.optim_lr), ss_prob_for_epoch(opt, epoch)
                opt.current_lr, opt.ss_prob = lr, ss_prob
                update_lr_flag = False
            start = time.time()
            data = loader.get_batch("train")
            batch = device_batch(data, device, compute_dtype)  # one copy for every seed
            losses = []
            for seed in seeds:
                seed.params, seed.opt_state, loss = train_step(
                    seed.params, seed.opt_state, *batch, lr, ss_prob, seed.generator)
                losses.append(loss)
            del batch
            if data["bounds"]["wrapped"]:
                epoch += 1
                update_lr_flag = True
            if iteration % opt.losses_log_every == 0:
                values = [float(x) for x in losses]
                for seed, v in zip(seeds, values):
                    seed.loss_history[iteration] = v
                lr_history[iteration], ss_prob_history[iteration] = lr, ss_prob
                jlog.log(event="fleet_train", iter=iteration, epoch=epoch, losses=values,
                         lr=lr, ss_prob=ss_prob, seconds=time.time() - start)
                log_fn(f"iter {iteration} (epoch {epoch}) losses: "
                       + " ".join(f"{v:.3f}" for v in values))
            del losses
            more, preempted = fleet.end_of_iteration(guard, iteration, epoch, histories,
                                                     max_iterations)
            iteration += 1
            if not more:
                break
        fleet.epilogue(iteration, epoch, histories, preempted, eval_at_end)
    finally:
        jlog.close()
        guard.close()
    return fleet.result(iteration, epoch, preempted, lr_history=lr_history,
                        ss_prob_history=ss_prob_history)


def train_multi_seed_rl(opt, loader, cider_scorer, n_seeds: int, *,
                        max_iterations: Optional[int] = None, eval_at_end: bool = True,
                        save: bool = True, log_fn=print):
    """Train an SCST fleet of ``n_seeds`` seeds on ``opt.device`` (CUDA
    unless "cpu"). Seed r starts as solo ``train_rl(rank=r)`` does: a warm
    start from its XE best triple ``model_{load_model_id}_{r}-best`` with
    ``opt.start_from`` (``--load_lr`` adopts the moments and derives the lr
    base), a resume from its rolling ``rl_`` triple under ``--rl_resume``,
    or drawn from its generator. Each iteration: one batch copy, each
    seed's fused sampled+greedy rollout, its host CIDEr-D reward, its
    policy-gradient step. Returns the dict of ``train_multi_seed`` with
    loss_histories the mean rewards (as the solo loop records them), and
    per seed train_loss_histories, lr_histories and rl_lr_bases."""
    device = resolve_device(opt.device)
    check_spice_weight(opt.spice_weight)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length
    model = setup(opt)
    rl_crit, tx = make_rl_criterion(opt), make_optimizer(opt)
    rl_resume = is_rl_resume(opt)
    seeds = []
    for r in range(n_seeds):
        params, opt_state, generator, infos, base = start_rl_state(
            opt, model, tx, loader, r, device, log_fn)
        seed = Seed(r, params, opt_state, generator,
                    Boundaries(opt, r, infos, prefix="rl_", resume_count=rl_resume), infos,
                    rl_lr_base=base)
        # the XE best triple this seed ships if it never beats its score: a
        # warm start's, or under --rl_resume the XE -best beside the rl_
        # triples where this run has no rl_-best yet (a fleet never
        # warm-started has none)
        seed.ship_xe = opt.start_from is not None and (not rl_resume or (
            not has_checkpoint(opt.checkpoint_path, opt.id, r, best=True, prefix="rl_")
            and has_checkpoint(opt.start_from, opt.load_model_id, r, best=True)))
        seeds.append(seed)
        if r == 0:
            infos0 = infos
    iteration, epoch = infos0.get("iter", 0), infos0.get("epoch", 0)

    def histories(seed):
        return dict(lr_history=seed.lr_history, rl_lr_base=seed.rl_lr_base)

    rollout_fn = make_rollout_fn(model)
    rl_step, old_logprobs_fn = make_rl_step(model, rl_crit, tx)
    jlog = JsonlLogger(opt.json_log or None)
    guard = PreemptGuard.from_opt(opt)
    fleet = Fleet(opt, model, loader, seeds, jlog, log_fn, save)
    update_lr_flag, preempted = True, False
    try:
        while True:
            if update_lr_flag:
                for seed in seeds:
                    seed.lr = lr_for_epoch(opt, epoch, seed.rl_lr_base)
                opt.current_lr = seeds[0].lr
                update_lr_flag = False
            start = time.time()
            data = loader.get_batch("train")
            fc, att, _, _, top_words = device_batch(data, device)
            rollouts = [rollout_fn(seed.params, fc, att, seed.generator) for seed in seeds]
            avg_rewards, losses = [], []
            for seed, (seq, greedy_seq) in zip(seeds, rollouts):
                rewards = compute_reward(
                    cider_scorer, seq.cpu().numpy(), greedy_seq.cpu().numpy(), data["gts"],
                    use_baseline=bool(opt.use_baseline), cider_weight=opt.cider_weight,
                    bleu4_weight=opt.bleu4_weight, spice_weight=opt.spice_weight)
                reward_dev = torch.as_tensor(rewards, dtype=torch.float32, device=device)
                if opt.use_ppo:
                    slp_old = old_logprobs_fn(seed.params, fc, att, seq)
                    for _ in range(opt.ppo_k + 1):
                        seed.params, seed.opt_state, loss = rl_step(
                            seed.params, seed.opt_state, fc, att, seq, reward_dev, top_words,
                            seed.lr, slp_old)
                else:  # the criterion reads no old log-probs without PPO
                    seed.params, seed.opt_state, loss = rl_step(
                        seed.params, seed.opt_state, fc, att, seq, reward_dev, top_words,
                        seed.lr, torch.zeros_like(reward_dev))
                avg_rewards.append(float(np.mean(rewards[:, 0])))
                losses.append(loss)
            del rollouts, fc, att, top_words
            if data["bounds"]["wrapped"]:
                epoch += 1
                update_lr_flag = True
            if iteration % opt.losses_log_every == 0:
                values = [float(x) for x in losses]
                for seed, reward, v in zip(seeds, avg_rewards, values):
                    seed.loss_history[iteration] = reward
                    seed.lr_history[iteration] = seed.lr
                    seed.train_loss_history[iteration] = v
                jlog.log(event="fleet_rl_train", iter=iteration, epoch=epoch,
                         avg_rewards=avg_rewards, losses=values,
                         lr=[s.lr for s in seeds], seconds=time.time() - start)
                log_fn(f"rl iter {iteration} (epoch {epoch}) avg rewards: "
                       + " ".join(f"{v:.3f}" for v in avg_rewards))
            del losses
            more, preempted = fleet.end_of_iteration(guard, iteration, epoch, histories,
                                                     max_iterations)
            iteration += 1
            if not more:
                break
        fleet.epilogue(iteration, epoch, histories, preempted, eval_at_end)
        if save and not preempted:
            for seed in seeds:
                if seed.ship_xe and not seed.best_written:
                    _ship_xe_best(opt, fleet, seed, iteration, epoch, histories)
    finally:
        jlog.close()
        guard.close()
    return fleet.result(iteration, epoch, preempted,
                        train_loss_histories=[s.train_loss_history for s in seeds],
                        lr_histories=[s.lr_history for s in seeds],
                        rl_lr_bases=[s.rl_lr_base for s in seeds])


def _ship_xe_best(opt, fleet, seed, iteration, epoch, histories):
    """A seed that never beat its warm-start score ships the XE best
    triple's weights and moments as its ``rl_``-best, with this run's
    infos, so ``eval_ensemble --rl_prefix 1`` finds every rank: the XE
    model and optimizer files are hard-linked under the rl_ names (nothing
    of them is kept on the host or written again)."""
    r = seed.rank
    link_triple(opt.start_from, opt.load_model_id, r, opt.checkpoint_path, opt.id,
                src_best=True, dst_best=True, dst_prefix="rl_", kinds=("model", "optimizer"))
    save_infos(opt.checkpoint_path, opt.id, r,
               fleet.snapshot(seed, iteration - 1, epoch, **histories(seed)), best=True,
               prefix="rl_")
    seed.best_written = True
    fleet.log_fn(f"seed {r} never beat its warm-start score: its XE best triple ships "
                 "as the rl_-best")
