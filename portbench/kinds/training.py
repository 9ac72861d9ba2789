"""What the two training kinds (``xe``, ``scst``) share: the data and the
port's loader, the weights, the clock that opens and closes the window on
the loop's log lines, the traced window, the readings of the optimizer's
state, and the check of the loader's batches against the corpus.

The loop is the port's own (``train_loop.train``, ``train_rl_loop.
train_rl``). Its ``log_fn`` is the ``Clock``: the loop calls it after each
step's loss is read. The window opens at the log line of step
``warmup_steps`` and closes at the first log line past ``--seconds``, where
the clock raises and the loop ends without its save; the rate is the images
of the whole steps between those two lines over the time between them. A
traced run profiles ``trace_steps`` steps from the window's start instead.
"""

from __future__ import annotations

import contextlib
import gc
import time
from unittest import mock

import numpy as np
import torch

from portbench.harness.data import Corpus, FeaturePool, PoolSource
from portbench.harness.job import WindowClosed
from portbench.harness.trace import Window
from portbench.harness.trees import leaves, leaves_with_paths
from portbench.harness.weights import make_weights
from portbench.kinds.common import model_layout, options, port_dataset
from portbench.reference import models as ref_models, xe as ref_xe


class Clock:
    """The loop's ``log_fn``: opens the window, traces or times it, closes it."""

    def __init__(self, job, on_open, on_trace_end):
        self.job, self.on_open, self.on_trace_end = job, on_open, on_trace_end
        self.warmup = job.traffic["warmup_steps"]
        self.calls = 0
        self.t0 = self.t1 = None
        self.steps = 0
        self.times = []

    def __call__(self, _line):
        now = time.time()
        self.calls += 1
        self.times.append(now)
        if self.calls <= self.warmup:
            self.job.mark(f"step {self.calls} read")
        if self.calls == self.warmup:
            self.t0 = now
            self.on_open()
            return
        if self.calls < self.warmup:
            return
        n = self.calls - self.warmup
        if self.job.trace:
            if n == self.job.traffic["trace_steps"]:
                self.t1, self.steps = now, n
                self.on_trace_end()
                raise WindowClosed
        elif now - self.t0 >= self.job.seconds:
            self.t1, self.steps = now, n
            raise WindowClosed


class StateReadings:
    """Reads the optimizer's state as the compared steps go: before step 2,
    the first gradient as Adam took it (its first moment / (1 - b1)); before
    step ``compared`` + 1, each leaf's change from the seed's weights. Both
    are queued on the device in stream order and read after the run."""

    def __init__(self, compared, b1, p0_fn):
        self.compared, self.b1, self.p0_fn = compared, b1, p0_fn
        self.grads = self.changes = None

    def before_step(self, i, params, opt_state):
        if i == 1:
            self.grads = torch.stack([torch.linalg.vector_norm(m) for m in
                                      leaves(opt_state.mu)]) / (1.0 - self.b1)
        if i == self.compared:
            p0 = self.p0_fn()
            self.changes = torch.stack([torch.linalg.vector_norm(p - q) for p, q in
                                        zip(leaves(params), leaves(p0))])
            del p0


def labels_of(corpus, ids, L):
    """Zero-bordered (rows, L + 2) labels and masks of the images' captions."""
    caps = np.concatenate([corpus.captions(i) for i in ids])
    labels = np.zeros((caps.shape[0], L + 2), np.int64)
    labels[:, 1:L + 1] = caps[:, :L]
    masks = (np.arange(L + 2)[None, :] < (labels != 0).sum(1)[:, None] + 2).astype(np.float32)
    return labels, masks


@contextlib.contextmanager
def control_precision(cuda):
    """The training cells' control: the reference one precision down from
    IEEE f32, in TF32 products. On the card TF32 is switched on for it; the
    CPU has none, so there its rounding is emulated. Yields the ``prec``."""
    if not cuda:
        yield ref_models.TF32()
        return
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield ref_models.F32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def optimizer_hyper(opt_settings, lr_key):
    o = opt_settings
    return {"grad_clip": o["grad_clip"], "weight_decay": o["optim_weight_decay"],
            "b1": o["optim_adam_beta1"], "b2": o["optim_adam_beta2"], "eps": o["optim_epsilon"],
            "lr": o[lr_key], "reason_weight": o["reason_weight"]}


class TrainingRun:
    """Set-up, window and teardown of one training cell."""

    def __init__(self, job):
        from recurrent_fusion_network_torch.data.loader import DataLoader

        self.job, cfg, tr = job, job.config, job.traffic
        self.cuda = job.device != "cpu"
        job.mark("port imported")
        self.opt = options(job, batch_size=tr["images_per_step"],
                           seq_per_img=tr["captions_per_image"], dtype=tr["dtype"], **tr["opt"])
        self.corpus = Corpus(job.seed, tr["train_images"], cfg["vocab_size"],
                             cfg["seq_length"], tr["captions_per_image"], tr["caption_length"],
                             cfg["top_words_count"])
        self.pool = FeaturePool(cfg["encoders"], tr["train_images"], job.seed, job.device)
        job.mark("pool made")
        self.loader = DataLoader(self.opt, port_dataset(self.corpus),
                                 [PoolSource(self.pool, j) for j in range(len(cfg["encoders"]))],
                                 prefetch=True)
        self.model, self.layout = model_layout(self.opt)
        self.weights = make_weights(self.layout, job.seed, job.device)
        job.mark("weights made")
        self.fault = job.check[6:] if job.check.startswith("fault:") else ""
        self.readings = StateReadings(tr["compared_steps"], tr["opt"]["optim_adam_beta1"],
                                      lambda: make_weights(self.layout, job.seed, job.device))
        self.batches = []
        self._record_batches()
        self.window = Window(job.spans, "train_loop", cpu=not self.cuda) if job.trace else None
        if self.window:
            self.window.prepare()
        self.marks = {}
        self.clock = Clock(job, self._open, self._trace_end)

    def _record_batches(self):
        """The loader's ``get_batch`` inside the benchmark's ``loader`` span;
        the first ``compared_steps`` batches' image ids, labels, masks and
        top words kept."""
        get_batch, keep = self.loader.get_batch, self.job.traffic["compared_steps"]

        def timed_get_batch(split, *a, **k):
            with self.job.spans.span("loader"):
                data = get_batch(split, *a, **k)
            if len(self.batches) < keep:
                self.batches.append({"ids": [inf["id"] for inf in data["infos"]],
                                     "labels": data["labels"].copy(),
                                     "masks": data["masks"].copy(),
                                     "top_words": data["top_words"].copy()})
            return data

        self.loader.get_batch = timed_get_batch

    def _launches(self):
        from recurrent_fusion_network_torch.kernels import additive_attention as aa

        return aa.launches, aa.bwd_launches

    def _open(self):
        self.marks["t0"] = self._launches()
        if self.window:
            self.window.start()

    def _trace_end(self):
        self.marks["t1"] = self._launches()
        self.window.stop()

    def loop(self, run_loop, patches):
        """Run the port's loop (``run_loop(log_fn)``) with the benchmark's
        weights and ``patches`` [(module, name, wrapper factory)] in place,
        until the clock closes the window; -> (peak bytes, e2e, counts)."""
        job, tr, clock = self.job, self.job.traffic, self.clock
        weights = self.weights
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        ctx = [mock.patch.object(type(self.model), "init_params",
                                 lambda self, generator, *, device=None: weights)]
        ctx += [mock.patch.object(mod, name, wrap(getattr(mod, name)))
                for mod, name, wrap in patches]
        try:
            for c in ctx:
                c.start()
            run_loop(clock)
        except WindowClosed:
            pass
        finally:
            for c in reversed(ctx):
                c.stop()
            self.loader.close()
        if self.cuda:
            torch.cuda.synchronize()
        if clock.t1 is None:
            raise RuntimeError("the loop ended before the window closed")
        peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        rate = clock.steps * tr["images_per_step"] / (clock.t1 - clock.t0)
        e2e = {"setup_s": clock.t0 - job.t_start, f"{tr['kind']}_images_per_s": rate}
        counts = {"units": clock.steps}
        if job.trace:
            counts["attn_fwd"] = self.marks["t1"][0] - self.marks["t0"][0]
            counts["attn_bwd"] = self.marks["t1"][1] - self.marks["t0"][1]
        return peak, e2e, counts

    def program_readings(self, losses):
        names = [".".join(p) for p, _ in leaves_with_paths(self.layout)]
        return {"losses": [float(x) for x in losses],
                "grads": dict(zip(names, self.readings.grads.tolist())),
                "changes": dict(zip(names, self.readings.changes.tolist()))}

    def free(self):
        """Drop the program's state before the reference runs."""
        del self.weights, self.model, self.readings
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def checked_batches(self):
        """-> (rows whose labels, masks or top words differ from the
        corpus's, [(ids, labels, masks, top-word targets)] as the reference
        derives them)."""
        cfg, L = self.job.config, self.job.config["seq_length"]
        bad, out = 0, []
        for b in self.batches:
            labels, masks = labels_of(self.corpus, b["ids"], L)
            tops = ref_xe.top_targets(labels, cfg["top_words_count"], L + 2)
            got, k = b["top_words"], tops.shape[1]
            same = ((got[:, :k] == tops.numpy()).all(1) & (got[:, k:] == -1).all(1)
                    & (b["labels"] == labels).all(1) & (b["masks"] == masks).all(1))
            bad += int((~same).sum())
            out.append((b["ids"], labels, masks, tops))
        return bad, out

    def step_times(self):
        t = self.clock.times
        return [round(b - a, 4) for a, b in zip(t, t[1:])]
