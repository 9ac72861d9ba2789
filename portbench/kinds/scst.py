"""SCST: the window drives ``training/train_rl_loop.py::train_rl`` itself
(``kinds/training.py`` sets up, opens and closes the window).

The port's CIDEr-D scorer is built over the corpus's document frequencies
(``data/prepro_ngrams.py::compute_doc_freq``, as ``main_rl`` builds it
without a df file) and its ``score_arrays`` runs inside the benchmark's
``reward`` span. The rollout (``make_rollout_fn``) and the step
(``make_rl_step``) are wrapped to keep, for the first three iterations,
the sampled and greedy tokens, the rewards the step got, the losses, the
first gradient as Adam took it and the parameters' change.

After the window the reference judges the first three iterations in turn
from the seed's weights: each rollout token against the reference's choice
with the same uniform draws, the rewards by its own CIDEr-D, and the step.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.harness.job import Outcome
from portbench.harness.trees import as_flat_dict, leaves
from portbench.harness.weights import make_weights
from portbench.kinds.common import port_seed
from portbench.kinds.training import TrainingRun, control_precision, optimizer_hyper
from portbench.reference import cider as ref_cider, compare, models as ref_models
from portbench.reference import scst as ref_scst


class Spy:
    """Wraps ``make_rollout_fn`` and ``make_rl_step``; plants a fault where
    asked."""

    def __init__(self, readings, compared, fault=""):
        self.readings, self.compared, self.fault = readings, compared, fault
        self.rollouts, self.rewards, self.losses = [], [], []
        self.steps = 0

    def rollout_factory(self, make):
        def make_spied(model):
            real = make(model)

            def rollout(*args):
                seq, greedy = real(*args)
                if self.fault == "token" and not self.rollouts:
                    seq = seq.clone()
                    seq[0, 0] = (seq[0, 0] + 1) % (model.vocab_size + 1)
                if len(self.rollouts) < self.compared:
                    self.rollouts.append((seq.clone(), greedy.clone()))
                return seq, greedy

            return rollout

        return make_spied

    def step_factory(self, make):
        def make_spied(*args, **kwargs):
            real, old_logprobs = make(*args, **kwargs)

            def step(params, opt_state, fc, att, seq, reward, top_words, lr, slp_old):
                i = self.steps
                self.steps += 1
                self.readings.before_step(i, params, opt_state)
                if self.fault == "reward" and i == 0:
                    reward = reward.clone()
                    reward[0] += 1.0
                if i < self.compared:
                    self.rewards.append(reward[:, 0].clone())
                if self.fault == "halfbatch":
                    h = seq.shape[0] // 2
                    fc, att = [x[:h] for x in fc], [x[:h] for x in att]
                    seq, reward, top_words, slp_old = (seq[:h], reward[:h], top_words[:h],
                                                       slp_old[:h])
                saved = ([p.clone() for p in leaves(params)] if self.fault == "unchanged"
                         else None)
                out = real(params, opt_state, fc, att, seq, reward, top_words, lr, slp_old)
                if saved is not None:
                    torch._foreach_copy_(leaves(params), saved)
                if i < self.compared:
                    self.losses.append(out[2].detach().clone())
                return out

            return step, old_logprobs

        return make_spied


def run(job) -> Outcome:
    from recurrent_fusion_network_torch.data.prepro_ngrams import compute_doc_freq
    from recurrent_fusion_network_torch.rewards.cider_d import CiderD
    from recurrent_fusion_network_torch.training import train_rl_loop

    tr = TrainingRun(job)
    ids = tr.loader.split_image_id["train"]
    scorer = CiderD(compute_doc_freq(tr.loader.dataset, ids), float(np.log(len(ids))))
    score_arrays = scorer.score_arrays

    def timed_score(*a, **k):
        with job.spans.span("reward"):
            return score_arrays(*a, **k)

    scorer.score_arrays = timed_score
    job.mark("scorer built")
    spy = Spy(tr.readings, job.traffic["compared_steps"], tr.fault)
    peak, e2e, counts = tr.loop(
        lambda log_fn: train_rl_loop.train_rl(tr.opt, tr.loader, scorer, log_fn=log_fn),
        [(train_rl_loop, "make_rollout_fn", spy.rollout_factory),
         (train_rl_loop, "make_rl_step", spy.step_factory)])
    prog = tr.program_readings(spy.losses)
    rollouts = [(s.cpu(), g.cpu()) for s, g in spy.rollouts]
    rewards = [r.double().cpu().numpy() for r in spy.rewards]
    del scorer
    tr.free()

    label_rows, batches = tr.checked_batches()
    cider = ref_cider.Cider([tr.corpus.captions(i) for i in tr.corpus.image_ids])
    ref = reference(job, tr, batches, rollouts, cider, ref_models.F32())
    numbers = compare.xe_numbers(prog, ref)
    numbers["rollout_gap"] = ref["rollout_gap"]
    numbers["reward_gap"] = max(float(np.abs(p - r).max())
                                for p, r in zip(rewards, ref["rewards"]))
    numbers["label_rows"] = label_rows
    calibration = {"excluded_leaves": numbers.pop("excluded_leaves"),
                   "losses": prog["losses"], "ref_losses": ref["losses"],
                   "worst": compare.worst_leaves(prog, ref),
                   "mean_reward": [float(r.mean()) for r in ref["rewards"]],
                   "step_s": tr.step_times()}
    if job.check == "control":  # the control's iterations stand where the program's stood
        with control_precision(tr.cuda) as prec:
            ctrl = reference(job, tr, batches, rollouts, cider, prec)
        calibration["program"] = dict(numbers)
        numbers.update(compare.xe_numbers(ctrl, ref), rollout_gap=ctrl["rollout_gap"])
        numbers.pop("excluded_leaves")
    return Outcome(e2e=e2e, attempted=tr.clock.steps, failed=0, numbers=numbers,
                   memory_peak_bytes=peak,
                   summary=tr.window.summary if tr.window else None,
                   counts=counts, calibration=calibration)


def reference(job, tr, batches, rollouts, cider, prec):
    """The reference's iterations on the program's rollouts."""
    cfg, traffic, dev = job.config, job.traffic, job.device
    o = traffic["opt"]
    hyper = dict(optimizer_hyper(o, "optim_rl_lr"), entropy_reg=o["entropy_reg"],
                 captions_per_image=traffic["captions_per_image"])

    def feed(ids, tops, seq, greedy):
        def load():
            fcs, atts = tr.pool.rows(ids, dev)
            return (fcs, atts, tops.to(dev), seq.to(dev), greedy.to(dev),
                    [tr.corpus.captions(i) for i in ids])
        return load

    feeds = [feed(ids, tops, s, g) for (ids, _, _, tops), (s, g) in zip(batches, rollouts)]
    P0 = as_flat_dict(make_weights(tr.layout, job.seed, dev))
    gen = torch.Generator(device=dev).manual_seed(port_seed(job.seed))
    out = ref_scst.run_iterations(P0, cfg, hyper, feeds, gen, cider, prec,
                                  traffic["reference_block_images"])
    del P0
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    return out
