"""Serving: a bulk-captioning client of the port's ``CaptionServer``.

Set-up: the weights from the seed, cast to the served dtype, the port's
``CaptionService`` over them (its ``warmup`` decodes one full batch), and
the feature pool. ``clients`` threads then keep ``outstanding`` requests
in flight between them, a closed loop: each submits one image's features
from the pool (image ids drawn from the seed) and, when its oldest request
resolves, submits the next. The window opens once ``warmup_batches``
batches of requests have resolved and lasts ``--seconds``: the rate is the
requests whose futures resolved inside it over its length. A traced run
profiles ``trace_batches`` batches from the window's start instead.

After the window the clients drain, the server closes and the program's
state is freed; a sample of the requests resolved in the window, drawn
from the seed with the longest caption among them, is run through the
reference, teacher-forced on each served caption: the served per-token
log-probs against the reference's for the same tokens and prefixes. The
reference's own beam search over the same features then judges the
search: its best caption's summed log-prob against the served caption's.
"""

from __future__ import annotations

import collections
import gc
import threading
import time
from unittest import mock

import numpy as np
import torch

from portbench.harness.data import Corpus, FeaturePool
from portbench.harness.env import sub_seed
from portbench.harness.job import Outcome
from portbench.harness.trace import Window
from portbench.harness.trees import as_flat_dict, leaves, rebuild
from portbench.harness.weights import make_weights
from portbench.kinds.common import model_layout, options
from portbench.reference import compare, models as ref_models

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Client:
    """``clients`` threads keeping ``outstanding`` requests in flight."""

    def __init__(self, job, server, pool, image_ids):
        self.job, self.server, self.pool, self.ids = job, server, pool, image_ids
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.next = 0
        self.done_at = []          # perf_counter of each resolution
        self.results = {}          # request index -> (image id, seq, lps, resolved at)
        self.failed = 0
        tr = job.traffic
        quota = -(-tr["outstanding"] // tr["clients"])
        self.threads = [threading.Thread(target=self._loop, args=(quota,), daemon=True)
                        for _ in range(tr["clients"])]

    def start(self):
        for t in self.threads:
            t.start()

    def _take(self):
        with self.lock:
            i = self.next
            self.next += 1
        return i

    def _resolved(self, i, image_id):
        def cb(fut):
            t = time.perf_counter()
            self.done_at.append(t)
            if fut.exception() is not None:
                with self.lock:
                    self.failed += 1
                return
            row = fut.result()
            self.results[i] = (image_id, row["seq"], row["seq_logprobs"], t)
        return cb

    def _loop(self, quota):
        inflight = collections.deque()
        while not self.stop.is_set():
            while len(inflight) < quota:
                i = self._take()
                image_id = int(self.ids[i % len(self.ids)])
                fcs, atts = self.pool.features(image_id)
                with self.job.spans.span("submit"):
                    fut = self.server.submit(fcs, atts)
                fut.add_done_callback(self._resolved(i, image_id))
                inflight.append(fut)
            inflight.popleft().exception()  # waits for it
        for fut in inflight:
            fut.exception()

    def join(self):
        self.stop.set()
        for t in self.threads:
            t.join()

    def batch_times(self, batch, n) -> list:
        """Seconds between the resolutions of each ``batch``-th request, over
        the first ``n`` batches' worth (the ramp the warm-up covers)."""
        t = sorted(self.done_at)[batch - 1::batch][:n]
        return [round(b - a, 4) for a, b in zip(t, t[1:])]

    def resolved_between(self, t0, t1) -> int:
        return sum(1 for t in list(self.done_at) if t0 <= t <= t1)


def run(job) -> Outcome:
    from recurrent_fusion_network_torch.decoding import api, http_serve
    from recurrent_fusion_network_torch.kernels import additive_attention as aa

    cfg, tr = job.config, job.traffic
    cuda = job.device != "cpu"
    opt = options(job)
    model, layout = model_layout(opt)
    dtype = DTYPES[tr["dtype"]]
    served = make_weights(layout, job.seed, job.device, dtype)
    pool = FeaturePool(cfg["encoders"], tr["pool_images"], job.seed, job.device)
    job.mark("pool made")
    corpus_words = Corpus(job.seed, 1, cfg["vocab_size"], cfg["seq_length"]).words()
    rng = np.random.default_rng(sub_seed(job.seed, "requests"))
    image_ids = rng.integers(1, tr["pool_images"] + 1, size=1 << 20)

    patches = []
    fault = job.check[6:] if job.check.startswith("fault:") else ""
    if fault == "altered":  # a token altered where the decode produces it
        real_sample = http_serve.model_sample

        def altered(*a, **k):
            out = real_sample(*a, **k)
            seq = out.seq.clone()
            seq[:, 2] = (seq[:, 2] + 1) % (cfg["vocab_size"] + 1)
            return out._replace(seq=seq)

        patches.append(mock.patch.object(http_serve, "model_sample", altered))
    if fault == "state":  # a decode step that returns its state unchanged
        real_step = api.make_step_fn

        def frozen(*a, **k):
            step = real_step(*a, **k)
            return lambda tokens, state: (step(tokens, state)[0], state)

        patches.append(mock.patch.object(api, "make_step_fn", frozen))
    for p in patches:
        p.start()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # faults of the search itself: greedy decoding, or a beam of two
    beam_size = {"greedy": 1, "beam2": 2}.get(fault, tr["beam_size"])
    service = http_serve.CaptionService(model, served, corpus_words, device=job.device,
                                        batch_size=tr["serve_batch"],
                                        beam_size=beam_size, depth=tr["serve_depth"])
    job.mark("service built")
    service.warmup()
    job.mark("service warmed up")
    server = service.server
    window = Window(job.spans, "serve", cpu=not cuda) if job.trace else None
    if window:
        window.prepare()
    client = Client(job, server, pool, image_ids)
    client.start()
    warm = tr["warmup_batches"] * tr["serve_batch"]
    while len(client.done_at) < warm:
        time.sleep(0.005)
    t0 = time.perf_counter()
    setup_s = time.time() - job.t_start
    counts = {}
    if job.trace:
        b0, l0 = server.stats["batches"], aa.launches
        window.start()
        while server.stats["batches"] - b0 < tr["trace_batches"]:
            time.sleep(0.001)
        b1, l1 = server.stats["batches"], aa.launches
        t1 = time.perf_counter()
        window.stop()
        counts = {"units": b1 - b0, "attn_fwd": l1 - l0, "attn_bwd": 0}
    else:
        time.sleep(max(0.0, t0 + job.seconds - time.perf_counter()))
        t1 = time.perf_counter()
    done = client.resolved_between(t0, t1)
    client.join()
    service.close()
    for p in patches:
        p.stop()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"setup_s": setup_s, "captions_per_s": done / (t1 - t0)}
    in_window = sorted(i for i, r in client.results.items() if t0 <= r[3] <= t1)
    failed = client.failed
    sample = pick_sample(job, client.results, in_window)
    del service, server, served, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers, extra = reference(job, layout, pool, sample, job.check == "control")
    calibration = dict(extra, sampled=len(sample), tokens=int(sum(n for *_, n in sample)),
                       batch_s=client.batch_times(tr["serve_batch"], tr["warmup_batches"] + 4))
    return Outcome(e2e=e2e, attempted=done, failed=failed, numbers=numbers,
                   memory_peak_bytes=peak, summary=window.summary if window else None,
                   counts=counts, calibration=calibration)


def served_length(seq) -> int:
    """Tokens compared: through the first EOS (0), or all of them."""
    z = np.nonzero(np.asarray(seq) == 0)[0]
    return int(z[0]) + 1 if len(z) else len(seq)


def pick_sample(job, results, in_window):
    """``sample_requests`` requests resolved in the window, drawn from the
    seed, the one with the longest caption among them."""
    if not in_window:
        return []
    n = min(job.traffic["sample_requests"], len(in_window))
    rng = np.random.default_rng(sub_seed(job.seed, "sample"))
    lengths = [served_length(results[i][1]) for i in in_window]
    longest = in_window[int(np.argmax(lengths))]
    picked = [int(x) for x in rng.choice(in_window, size=n, replace=False)]
    if longest not in picked:
        picked[0] = longest
    out = []
    for i in sorted(picked):
        image_id, seq, lps, _ = results[i]
        out.append((image_id, np.asarray(seq), np.asarray(lps, np.float32),
                    served_length(seq)))
    return out


def reference(job, layout, pool, sample, with_control):
    """-> (numbers, calibration extras). The reference runs in f32 over the
    served weights' values (rounded to the served dtype): teacher-forced on
    each served caption (``lp_gap``), and its own beam search over the same
    features, whose best caption's summed log-prob the served caption's is
    held against (``beam_gap``). With ``with_control`` the control, the
    same teacher-forced pass in fp8 products, stands where the served
    log-probs stand."""
    cfg, tr = job.config, job.traffic
    dev = job.device
    if not sample:
        return {"lp_gap": float("inf"), "beam_gap": float("inf")}, {}
    dtype = DTYPES[tr["dtype"]]
    w = make_weights(layout, job.seed, dev)
    P = as_flat_dict(rebuild(layout, [x.to(dtype).float() for x in leaves(w)]))
    del w
    fcs, atts = pool.rows([s[0] for s in sample], dev, dtype)
    fcs, atts = [x.float() for x in fcs], [x.float() for x in atts]
    seqs = torch.from_numpy(np.stack([s[1] for s in sample])).to(dev, torch.long)
    served = torch.from_numpy(np.stack([s[2] for s in sample])).to(dev)
    lengths = [s[3] for s in sample]

    def token_lps(prec):
        seq_in = torch.cat([torch.zeros_like(seqs[:, :1]), seqs[:, :-1]], dim=1)
        with torch.no_grad():
            lps, _ = ref_models.teacher_forced(P, cfg, fcs, atts, seq_in, prec)
        return lps.gather(2, seqs[..., None])[..., 0]

    ref = token_lps(ref_models.F32())
    extra = {}
    if with_control:
        extra["program"] = compare.decode_numbers(served, ref, lengths)
        served = token_lps(ref_models.Quantized())
    numbers = compare.decode_numbers(served, ref, lengths)
    _, best = ref_models.beam_search(P, cfg, fcs, atts, tr["beam_size"], ref_models.F32())
    served_sums = [float(r[:n].sum()) for r, n in zip(ref, lengths)]
    beam = compare.beam_numbers(served_sums, best.tolist())
    numbers["beam_gap"] = beam.pop("beam_gap")
    extra.update(beam)
    return numbers, extra
