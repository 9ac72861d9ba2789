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
as its ``rl_``-best, so the ``rl_`` ensemble is complete. An SCST
fleet's warm start begins as the JAX fleet's (JAX multi_seed.py:653-680,
:739-744): iteration and epoch 0, the loader as this process built it,
every history empty; it takes from the XE triple only the params, under
--load_lr the moments and the lr base, and under --load_best_score the
best score. (The solo loops, in both packages, carry on the XE triple's
count, loader and histories.) Both fleets' dicts hold the JAX fleets'
keys (``Fleet.result``).

Triples go through ``checkpoint.backend(opt)`` (pickle, or DCP directories
under ``--checkpoint_backend orbax``); an SCST fleet with --spice_weight > 0
shares one SPICE hook among its seeds.

The fleet over ranks (``mesh``, a data-parallel group of D processes; JAX
``_shard_seed_axis`` / ``_local_seed_ids`` / ``_seed_row``,
multi_seed.py:58-125): rank k owns seeds [k S / D, (k + 1) S / D) and runs
them as above, seed by seed; every rank reads the full stream (the fleet's
loader is never sharded), no gradient crosses ranks, and each rank writes
its own seeds' triples, so S must divide by D and the backend must be
pickle past one process (a DCP save is collective; JAX
multi_seed.py:178). The early stop and the SIGTERM stop are agreed over
the ranks. Seed r follows the single-process fleet's seed r bit for bit.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..convert import params_from_jax
from ..data.pinned import device_batch
from ..device import resolve_device
from ..metrics.spice import make_spice_fn
from ..models import setup
from ..ops.initializers import tree_leaves, tree_map
from ..parallel.distributed import all_hosts_agree
from ..parallel.mesh import MP_FLEET
from ..rewards.self_critical import compute_reward
from ..utils.logging import JsonlLogger
from .checkpoint import backend
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
        self.best_params = None  # the params of its best eval, on the host


class Fleet:
    """What the XE and SCST fleets share: the per-seed boundary (eval, the
    rolling triple and, at an improvement, the -best one: one host copy,
    written once), the early-stop verdict and the epilogue eval."""

    def __init__(self, opt, model, loader, seeds, jlog, log_fn, save):
        self.opt, self.model, self.loader, self.seeds = opt, model, loader, seeds
        self.jlog, self.log_fn, self.save = jlog, log_fn, save
        self.ranks = [s.rank for s in seeds]

    def snapshot(self, seed, iteration, epoch, **histories):
        infos = seed.bounds.snapshot(self.loader, seed.generator, iteration, epoch,
                                     loss_history=seed.loss_history, **histories)
        infos["no_improve"] = seed.bounds.num_period_best  # the JAX fleet's key
        return infos

    def evaluate(self, at_iter, last_step, epoch, histories, *, rolling):
        """Every seed's val eval at the params after step ``last_step``
        (recorded under ``at_iter``); with ``rolling`` its rolling triple,
        and where it improved its -best one (a hard link to the rolling
        files, or written itself without ``rolling``) and its
        ``best_params``. -> whether every seed is stagnant."""
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
            write = self.save and (best or rolling)
            t0 = time.time()
            host = to_host(seed.params, seed.opt_state, self.opt) if write else None
            if best:
                seed.best_params = host_params(seed.params, host)
            if not write:
                continue
            seed.bounds.write(host, self.snapshot(seed, last_step, epoch, **histories(seed)),
                              best=best, rolling=rolling)
            seed.best_written = seed.best_written or best
            save_s += time.time() - t0
        self.log_fn(f"iter {at_iter} fleet val scores: "
                    + " ".join("-" if s is None else f"{s:.3f}" for s in scores))
        self.jlog.log(event="fleet_val", iter=at_iter, ranks=self.ranks, scores=scores,
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
            # every seed stagnant, on every rank of a fleet over ranks
            stop = all_hosts_agree(self.evaluate(iteration, iteration, epoch, histories,
                                                 rolling=True))
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

    def result(self, iteration, epoch, preempted, n_seeds, histories="loss_histories",
               **extra):
        """The fleet's dict. The per-seed lists hold this process's seeds in
        order, but ``best_params``, which is ``n_seeds`` long and indexed by
        seed (None for another rank's seeds), as JAX's; ``local_seeds``
        (= ``ranks``) names them. ``histories``: the key of the logged
        per-seed values (the JAX SCST fleet's is reward_histories)."""
        best_params = [None] * n_seeds
        for s in self.seeds:
            best_params[s.rank] = s.best_params
        return dict(iter=iteration, epoch=epoch, model=self.model, preempted=preempted,
                    ranks=self.ranks, local_seeds=list(self.ranks),
                    params=[s.params for s in self.seeds],
                    opt_states=[s.opt_state for s in self.seeds],
                    best_params=best_params,
                    val_histories=[s.bounds.val_result_history for s in self.seeds],
                    cider_per_seed=[s.bounds.best_val_score for s in self.seeds],
                    **{histories: [s.loss_history for s in self.seeds]}, **extra)


def host_params(params, host):
    """A seed's params on the host as a tensor tree, at an improvement:
    the arrays of the triple's ``to_host`` copy where it was made off a
    card (no second copy from the device); on the CPU, or without a
    triple, a copy of their own (the step updates the params in place, and
    on the CPU ``to_host`` gives views of them)."""
    if host is not None and tree_leaves(params)[0].device.type != "cpu":
        return tree_map(torch.from_numpy, host[0])
    return tree_map(lambda t: t.detach().to("cpu", copy=True), params)


def local_seeds(opt, n_seeds: int, mesh=None) -> range:
    """The seeds this process trains: all of them alone, rank k's block
    [k S / D, (k + 1) S / D) of a fleet over D ranks (JAX
    ``_local_seed_ids``)."""
    if mesh is None:
        return range(n_seeds)
    if mesh.mp > 1:  # JAX main.py:53-56
        raise ValueError(MP_FLEET)
    if n_seeds % mesh.world:
        raise ValueError(f"--n_seeds {n_seeds} must divide by the {mesh.world} ranks of "
                         "the fleet")
    if mesh.world > 1 and backend(opt).collective:
        # each rank writes its own seeds' triples, a different number of
        # times per boundary; a DCP save is collective (JAX multi_seed.py:178)
        raise ValueError("a fleet over several ranks needs --checkpoint_backend pickle: "
                         "its seeds' triples are written by their own ranks, and a DCP "
                         "save is collective over all of them")
    per = n_seeds // mesh.world
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def _more(opt, epoch, iteration, max_iterations):
    return (not (opt.max_epochs != -1 and epoch >= opt.max_epochs)
            and not (max_iterations is not None and iteration + 1 >= max_iterations))


def train_multi_seed(opt, loader, n_seeds: int, *, max_iterations: Optional[int] = None,
                     eval_at_end: bool = True, save: bool = True, log_fn=print, mesh=None):
    """Train an XE fleet of ``n_seeds`` seeds on ``opt.device`` (CUDA
    unless "cpu"). Seed r starts as solo ``train(rank=r)`` does: drawn from
    the generator seeded with opt.seed + r, or with ``opt.start_from``
    resumed from its rolling triple ``model_{load_model_id}_{r}``. Returns
    a dict: iter, epoch, model, preempted, and per seed params, opt_states,
    loss_histories, val_histories, cider_per_seed (the best score) and
    best_params (the params of that eval, on the host; None for a seed
    never scored), with the shared lr_history and ss_prob_history. With a
    data-parallel ``mesh`` this rank trains its block of the seeds
    (``local_seeds``), and the per-seed lists (and ``ranks``) are its
    seeds' (``Fleet.result``)."""
    device = resolve_device(opt.device)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length
    model = setup(opt)
    crit, tx = make_criterion(opt), make_optimizer(opt)
    seeds = []
    for r in local_seeds(opt, n_seeds, mesh):
        params, opt_state, generator, infos = start_state(opt, model, tx, loader, r, device)
        seeds.append(Seed(r, params, opt_state, generator, Boundaries(opt, r, infos), infos))
        if len(seeds) == 1:
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
                jlog.log(event="fleet_train", iter=iteration, epoch=epoch, ranks=fleet.ranks,
                         losses=values, lr=lr, ss_prob=ss_prob, seconds=time.time() - start)
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
    backend(opt).wait_until_finished()  # async barrier
    return fleet.result(iteration, epoch, preempted, n_seeds, lr_history=lr_history,
                        ss_prob_history=ss_prob_history)


def train_multi_seed_rl(opt, loader, cider_scorer, n_seeds: int, *,
                        max_iterations: Optional[int] = None, eval_at_end: bool = True,
                        save: bool = True, log_fn=print, mesh=None):
    """Train an SCST fleet of ``n_seeds`` seeds on ``opt.device`` (CUDA
    unless "cpu"). Seed r starts from the state of solo ``train_rl(rank=r)``
    (``start_rl_state``): a warm start from its XE best triple
    ``model_{load_model_id}_{r}-best`` with ``opt.start_from`` (``--load_lr``
    adopts the moments and derives the lr base), a resume from its rolling
    ``rl_`` triple under ``--rl_resume``, or drawn from its generator. A
    warm start counts as the JAX fleet's does, not as the solo loop's: from
    iteration and epoch 0, on the loader as built, with every history
    empty (only the best score comes from the triple), so
    ``max_iterations`` counts SCST iterations. Each iteration: one batch
    copy, each seed's fused sampled+greedy rollout, its host CIDEr-D
    reward, its policy-gradient step. Returns the dict of
    ``train_multi_seed`` with reward_histories (the mean rewards, which the
    solo loop records as its loss_history) in place of loss_histories, and
    per seed train_loss_histories, lr_histories and rl_lr_bases; a
    warm-started seed that never beat its warm-start score has the XE best
    triple's params as its best_params, as in JAX. ``mesh``: the fleet over
    ranks, as in ``train_multi_seed``."""
    device = resolve_device(opt.device)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length
    model = setup(opt)
    rl_crit, tx = make_rl_criterion(opt), make_optimizer(opt)
    rl_resume = is_rl_resume(opt)
    warm = opt.start_from is not None and not rl_resume
    ckpt = backend(opt)
    seeds = []
    for r in local_seeds(opt, n_seeds, mesh):
        params, opt_state, generator, infos, base = start_rl_state(
            opt, model, tx, loader, r, device, log_fn, restore_loader=not warm)
        if warm:
            # the JAX fleet's warm start: iteration and epoch 0, the loader
            # as built, no history of the XE run (JAX multi_seed.py:739-744);
            # the best score only (:671-672)
            infos = {"best_val_score": infos.get("best_val_score")}
        seed = Seed(r, params, opt_state, generator,
                    Boundaries(opt, r, infos, prefix="rl_", resume_count=rl_resume), infos,
                    rl_lr_base=base)
        # the XE best triple this seed ships if it never beats its score: a
        # warm start's, or under --rl_resume the XE -best beside the rl_
        # triples where this run has no rl_-best yet (a fleet never
        # warm-started has none)
        seed.ship_xe = warm or (rl_resume and (
            not ckpt.has_checkpoint(opt.checkpoint_path, opt.id, r, best=True, prefix="rl_")
            and ckpt.has_checkpoint(opt.start_from, opt.load_model_id, r, best=True)))
        seeds.append(seed)
        if len(seeds) == 1:
            infos0 = infos
    iteration, epoch = infos0.get("iter", 0), infos0.get("epoch", 0)

    def histories(seed):
        return dict(lr_history=seed.lr_history, rl_lr_base=seed.rl_lr_base)

    rollout_fn = make_rollout_fn(model)
    rl_step, old_logprobs_fn = make_rl_step(model, rl_crit, tx)
    # one SPICE scorer for every seed (JAX multi_seed.py:719-723)
    spice_fn = make_spice_fn(opt, loader.get_vocab()) if opt.spice_weight > 0 else None
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
                    bleu4_weight=opt.bleu4_weight, spice_weight=opt.spice_weight,
                    spice_fn=spice_fn)
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
                jlog.log(event="fleet_rl_train", iter=iteration, epoch=epoch, ranks=fleet.ranks,
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
    ckpt.wait_until_finished()  # async barrier
    for seed in seeds:
        if seed.ship_xe and seed.best_params is None:
            # never beat its warm start: the XE best triple is its best
            # (JAX multi_seed.py:742), read back from the disk
            seed.best_params = params_from_jax(ckpt.load_checkpoint(
                opt.start_from, opt.load_model_id, seed.rank, best=True)[0])
    return fleet.result(iteration, epoch, preempted, n_seeds, histories="reward_histories",
                        train_loss_histories=[s.train_loss_history for s in seeds],
                        lr_histories=[s.lr_history for s in seeds],
                        rl_lr_bases=[s.rl_lr_base for s in seeds])


def _ship_xe_best(opt, fleet, seed, iteration, epoch, histories):
    """A seed that never beat its warm-start score ships the XE best
    triple's weights and moments as its ``rl_``-best, with this run's
    infos, so ``eval_ensemble --rl_prefix 1`` finds every rank: the XE
    model and optimizer files are hard-linked under the rl_ names (nothing
    of them is kept on the host or written again)."""
    r, ckpt = seed.rank, backend(opt)
    ckpt.link_triple(opt.start_from, opt.load_model_id, r, opt.checkpoint_path, opt.id,
                     src_best=True, dst_best=True, dst_prefix="rl_",
                     kinds=("model", "optimizer"))
    ckpt.save_infos(opt.checkpoint_path, opt.id, r,
                    fleet.snapshot(seed, iteration - 1, epoch, **histories(seed)), best=True,
                    prefix="rl_")
    seed.best_written = True
    fleet.log_fn(f"seed {r} never beat its warm-start score: its XE best triple ships "
                 "as the rl_-best")
