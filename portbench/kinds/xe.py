"""XE training: the window drives ``training/train_loop.py::train`` itself
(``kinds/training.py`` sets up, opens and closes the window).

``make_train_step`` is wrapped by ``StepSpy``, which passes every call
through and keeps, for the first three steps, the losses, the first
gradient as Adam took it and the parameters' change after the three.
After the window the program's state is freed and the reference trains the
same three steps from the same weights on the batches the loader handed
over, rebuilt from the corpus and the pool by the image ids it named, with
the dropout masks drawn from the same seed in the cells' order.
"""

from __future__ import annotations

import gc

import torch

from portbench.harness.job import Outcome
from portbench.harness.trees import as_flat_dict, leaves
from portbench.harness.weights import make_weights
from portbench.kinds.common import port_seed
from portbench.kinds.training import TrainingRun, control_precision, optimizer_hyper
from portbench.reference import compare, models as ref_models, xe as ref_xe


class StepSpy:
    """Wraps ``make_train_step``; plants a fault where asked."""

    def __init__(self, readings, compared, fault=""):
        self.readings, self.compared, self.fault = readings, compared, fault
        self.calls = 0
        self.losses = []

    def factory(self, make):
        def make_spied(*args, **kwargs):
            real = make(*args, **kwargs)

            def step(params, opt_state, fc, att, labels, masks, top_words, *rest):
                i = self.calls
                self.calls += 1
                self.readings.before_step(i, params, opt_state)
                if self.fault == "halfbatch":
                    h = labels.shape[0] // 2
                    fc, att = [x[:h] for x in fc], [x[:h] for x in att]
                    labels, masks, top_words = labels[:h], masks[:h], top_words[:h]
                saved = ([p.clone() for p in leaves(params)] if self.fault == "unchanged"
                         else None)
                out = real(params, opt_state, fc, att, labels, masks, top_words, *rest)
                if saved is not None:
                    torch._foreach_copy_(leaves(params), saved)
                if i < self.compared:
                    self.losses.append(out[2].detach().clone())
                return out

            return step

        return make_spied


def run(job) -> Outcome:
    from recurrent_fusion_network_torch.training import train_loop

    tr = TrainingRun(job)
    spy = StepSpy(tr.readings, job.traffic["compared_steps"], tr.fault)
    peak, e2e, counts = tr.loop(lambda log_fn: train_loop.train(tr.opt, tr.loader,
                                                                  log_fn=log_fn),
                                [(train_loop, "make_train_step", spy.factory)])
    prog = tr.program_readings(spy.losses)
    tr.free()

    label_rows, batches = tr.checked_batches()
    ref = reference(job, tr, batches, ref_models.F32())
    numbers = compare.xe_numbers(prog, ref)
    numbers["label_rows"] = label_rows
    calibration = {"excluded_leaves": numbers.pop("excluded_leaves"),
                   "losses": prog["losses"], "ref_losses": ref["losses"],
                   "worst": compare.worst_leaves(prog, ref), "step_s": tr.step_times()}
    if job.check == "control":  # the control's steps stand where the program's stood
        with control_precision(tr.cuda) as prec:
            ctrl = reference(job, tr, batches, prec)
        calibration["program"] = dict(numbers)
        numbers.update(compare.xe_numbers(ctrl, ref))
        numbers.pop("excluded_leaves")
    return Outcome(e2e=e2e, attempted=tr.clock.steps, failed=0, numbers=numbers,
                   memory_peak_bytes=peak,
                   summary=tr.window.summary if tr.window else None,
                   counts=counts, calibration=calibration)


def reference(job, tr, batches, prec):
    """The reference's steps on the loader's batches."""
    cfg, traffic, dev = job.config, job.traffic, job.device
    o = traffic["opt"]
    hyper = dict(optimizer_hyper(o, "optim_lr"),
                 rates={"fusion": o.get("drop_prob_fusion", 0.0),
                        "reason": o.get("drop_prob_reason", 0.0),
                        "lm": o.get("drop_prob_lm", 0.0)},
                 label_smoothing=(o["label_smoothing_epsilon"] if o.get("use_label_smoothing")
                                  else 0.0),
                 captions_per_image=traffic["captions_per_image"])

    def feed(ids, labels, masks, tops):
        def load():
            fcs, atts = tr.pool.rows(ids, dev)
            return (fcs, atts, torch.from_numpy(labels).to(dev),
                    torch.from_numpy(masks).to(dev), tops.to(dev))
        return load

    P0 = as_flat_dict(make_weights(tr.layout, job.seed, dev))
    gen = torch.Generator(device=dev).manual_seed(port_seed(job.seed))
    out = ref_xe.run_steps(P0, cfg, hyper, [feed(*b) for b in batches], gen, prec,
                           traffic["reference_block_images"])
    del P0
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    return out
