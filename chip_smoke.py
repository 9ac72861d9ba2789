"""Chip smoke test of the PyTorch / CUDA port on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. device:  requires CUDA, prints the card's name and power limit, and
              turns TF32 off for matmuls and cuDNN;
  2. build:   compiles every kernel of the port from csrc/ with nvcc for
              sm_90a (one nvcc per source, all started together) and, beside
              them, the host libraries with g++ into build/native/: the
              CIDEr-D scorer (csrc/cider_d.cpp) and the sharded store's row
              gather (csrc/feature_io.cpp);
  3. kernels: additive_attention_fwd against its plain PyTorch version at
              every shape the serving and training paths give it (flagship
              widths, B = 512: stage I, stage II with G = 5, the decoder at
              B * beam 3 rows and at B rows), in f32 and bf16, with errors, a
              bitwise repeat, device times (CUDA events around calls queued
              behind a busy stream; torch.profiler's kernel times and event
              times with the host's launch gaps beside them), the bound
              (bytes / 3.35 TB/s vs operations /
              67 TFLOP/s f32) and achieved GB/s; sums per beam-3 batch and
              per train step;
  4. slice:   the flagship RecurrentFusionModel (tied keys, random weights
              from a seeded torch.Generator): f32 beam-3 tokens with the
              kernel equal those with the plain version; then a bf16
              CaptionService (batch 16, beam 3) behind the threaded HTTP
              front end answers concurrent /caption requests with npz bodies,
              with the launch counters reset just before and read just
              after (64 launches of additive_attention_fwd per batch, none on
              the kernels' scalar path);
  5. throughput: B = 512 beam-3 bf16 decodes through pipelined_map, one of
              them queued under CUDA sync debug mode "error" (no host sync
              inside the decode), then one batch under torch.profiler;
  6. train:   the XE train step. additive_attention_bwd against its plain
              version at every training call site (5 stage-I encoders,
              stage II with G = 5, the decoder; 512 rows; f32 and bf16),
              with errors, a bitwise repeat, device and event times, the
              bound and achieved GB/s; an f32 flagship step at 16 rows, 3 Adam steps with the
              kernels vs with the plain versions patched in (loss and params
              within tolerance; every grad leaf finite and non-zero but the
              score biases); bf16 flagship steps at 512 rows through
              train() on a fixed batch of seeded random numpy features, with
              the launch counters reset just before and read just after
              (65 + 65 launches per step, none on the scalar path), a
              falling loss, step time,
              rows/s, peak memory, and one profiled step;
  7. SCST:    the self-critical step in f32 at bench.py::bench_rl's batch
              (B = 256, one image per row with 5 random references, a
              CIDEr-D scorer with 1,000,000 df entries on its native
              engine). Both kernels against their plain versions at its
              sites (stage I and II at B rows, the rollout's decoder at 2B
              lanes, the step's decoder at B rows); an f32 iteration at 16
              rows with the kernels vs with the plain versions patched in
              (rollout tokens, then the step's loss and grads); 10
              iterations through train_rl() with --rl_overlap 1 and again
              with 0, the launch counters reset just before and read just
              after each (130 + 65 launches per iteration, none on the
              scalar path), iteration time and images/s; serial iterations
              split into batch copy, rollout, host reward and grad step;
              one profiled iteration; peak memory;
  8. drivers: the training and evaluation CLIs on a data set at the flagship
              widths written under build/ (9,487 words, 300 / 100 / 100
              train / val / test images x 5 captions, packed stores of the
              five registry encoders: 1.6 GB; 25 GB free asked for, as a
              flagship triple is 5.4 GB): main (bf16, 100 images x 5, 21
              steps, a boundary at 20 with beam-3 eval_split, the 8 metrics
              and the triples), eval of the best triple on the test split,
              main_rl (f32, 51 images x 5) warm-started from it, 21
              iterations with a boundary at 40, under --rl_overlap 1 and 0.
              Counters reset before and read after each run: 65 + 65
              launches per XE step, 130 + 65 per SCST iteration, 65 + 64 per
              eval batch, none on the scalar path; every launch's shape
              recorded, and both kernels checked against their plain
              versions at each of those shapes (tolerances and bitwise
              repeat of phases 3 and 6; times summed per eval batch and
              over the phase); metrics finite; the files the JAX package's
              tags name. Prints step / iteration ms (median and quartiles of
              the fetch-to-fetch gaps clear of a boundary), the side-stream
              batch copy and the share of it under the step before, eval
              (decode vs metrics) and triple-write ms, and the optimizer
              file's write with the checkpoint writer's pure-Python pickler
              against the C pickler. Files are deleted when done. Its argv
              names --caption_model recurrent_fusion_model (the CLIs'
              default is show_tell, as in the JAX package);
  9. models:  ShowTell (resnet fc 2048, E = R = 512, 1 layer) and ReviewNet
              (inception_v3: fc 2048, att 64 x 1280; 8 review steps, H = 512,
              1000 top words) in three variants, tied keys, untied
              (--reference_parity) and the 10-expert MoS head; vocab 9487,
              16 tokens, random weights from a seeded generator. Both
              kernels against their plain versions at every ReviewNet site
              (review cells at A = 64, D = 1280; the decoder over the 8
              thought vectors at B * beam, B and 2B rows; f32 and bf16; as
              phases 3 and 6). Per model: f32 beam-3 tokens with the kernels
              equal to those with the plain versions (ReviewNet); a bf16
              CaptionService (batch 16) behind the HTTP front end; B = 512
              beam-3 captions/s; 20 bf16 XE steps through train() on a fixed
              batch of 100 images x 5 (step median and quartiles, peak
              memory); 10 f32 SCST iterations through train_rl() at B = 256.
              The counters are reset just before and read just after each
              path: ReviewNet launches 8 + 16 forward per beam-3 batch,
              8 + 17 of each kernel per XE step and (8 + 17) x 2 + (8 + 17)
              per SCST iteration, ShowTell none, none on the scalar path;
 10. fleets:  the multi-seed fleets and the mean-logit ensemble at flagship
              width: a 2-member f32 ensemble of two seeded inits, whose
              beam-3 tokens on 16 images with the kernel equal those with
              the plain version; then on phase 8's data set (with flip
              features of the 100 test images) main --n_seeds 4 (bf16, 100
              images x 5, 11 steps, the boundary at 10), main_rl --n_seeds 4
              warm-started from its best triples (f32, 51 images x 5,
              iterations 11..16, the boundary at 16), eval_ensemble --n_ranks
              4 --rl_prefix 1 --beam_size 3 --dtype bfloat16 on the test
              images without, with and again without --eval_flip_ensemble 1,
              and a 4-member bf16 B = 512 ensemble beside phase 5's solo
              rate. Counters reset before and read after each run: 4 x (65 +
              65) per XE iteration, 4 x (130 + 65) per SCST iteration, 129
              per seed per eval batch, 4 x 64 per ensemble batch (8 x 64
              under flip); iteration ms (median and quartiles of the fetch
              gaps), ms per seed, the boundary's eval and triple seconds,
              peak memory at S = 4 and the reckoned S = 8 peak;
 11. remat, optimizers, data front: (a) phase 6's B = 512 bf16 batch with
              dropout at the flagship rates (0.3, scripts/train_recurrent_
              fusion_model.sh) and ss_prob 0.3, 12 steps each without remat,
              under --remat_policy full and under save_ctx (and one more
              step without, the spread of two runs), from the same params
              and generator state: the first step's loss and every grad
              leaf against the run without remat (no further apart than the
              two runs without it), launches per step exactly 65 + 65, 130 +
              65 (the recompute launches each forward again) and 65 + 65
              (save_ctx keeps the reads' outputs), step ms (median of the
              last 10), the memory held at the end of the forward and the
              forward's and the step's peaks; (b) 3 bf16 steps each of rmsprop
              (momentum 0.9), adagrad (lr_decay 0.01) and adadelta: loss,
              params and every state leaf finite, step ms, peak memory; (c)
              the runbook's data front through the CLIs under build/: a
              Karpathy JSON of 300 / 100 / 100 images x 5 captions whose
              words are phase 8's 9,487 -> prepro_labels
              --word_count_threshold 1 (exactly those words) ->
              prepro_ngrams --karpathy_json -> seeded f32 packed stores of
              the five encoders -> pack_to_shards (64 rows a shard); 3
              train batches from the sharded stores (the native gather)
              equal byte for byte to the packed stores', with the loader's
              fetch ms of each; main (bf16, 100 x 5, --use_remat 1
              --remat_policy save_ctx --optim rmsprop, 11 steps, the
              boundary at 10) and main_rl --cider_df <prepro_ngrams' pickle>
              --load_lr 1 from its best triple (f32, 51 x 5, iterations
              11..16, the boundary at 16); exact launches, finite metrics.
              Phase 8's, 10's and 11's CLI shapes are then checked against
              the plain versions as in phase 8;
 12. raw images: (a) the five runbook backbones at their native geometry
              (resnet101 448 px -> 14 x 14, densenet161 224 -> 7 x 7,
              inception_v3 / inception_v4 / inception_resnet_v2 299 -> 8 x 8),
              random weights from a seeded generator: fc and att on the card
              (cuDNN TF32 off, scoped) against the same backbone on the CPU
              at B = 2, max |diff| / max |CPU| within 1e-3; the same with TF32
              on; ms per B = 16 batch with TF32 off and on (CUDA events),
              images/s, the peak GB above the weights, the host's ms to
              queue one forward; the bound 2 x MACs / 67 TFLOP/s (f32) and /
              495 TFLOP/s (TF32), MACs counted from the convolutions' shapes
              on the meta device; the forward kernel against its plain
              version at ReviewNet's sites on the resnet grid (8 review steps
              at 16 x 196 x 2048, 16 beam steps at 48 x 8 x 512; f32 and
              bf16); (b) under build/: 64 seeded JPEGs (32 at 448 x 448, 32
              of mixed sizes) and a seeded torchvision-layout resnet101
              state dict; the extract CLI (resnet101, --variants all) packed
              in 64-image runs, its rows against an in-process forward of
              the same images, then sharded (equal rows), then a SIGTERM
              while the third chunk decodes and the same command again (the
              same bytes as the uninterrupted run); images/s, the host's
              decode / resize share; (c) ShowTell and ReviewNet triples on
              the resnet features at published widths (vocab 9487), eval
              --image_folder --backbone_weights on the 64 JPEGs: images/s,
              launches 24 per beam-3 batch (ReviewNet), none (ShowTell);
              (d) serve --backbone_weights over the ReviewNet triple (f32):
              32 concurrent POST /caption_image of the 448 x 448 JPEGs,
              captions equal to (c)'s for the same files, latency p50 / p95,
              launches 24 per decoded batch. Counters reset just before and
              read just after each run; every launch's shape is one checked.
The line before the last is the kernels JSON, the last line the device JSON.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
BATCH, BEAM, HID = 512, 3, 512
SERVE_BATCH, N_REQUESTS = 16, 36  # 36 = 2 full batches + a partial one
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),  # sum order, tanhf ulps
       "bfloat16": dict(rtol=1e-2, atol=1.6e-2)}  # one bf16 ulp of |z| < 4
# backward: |kernel - plain| <= rtol * |plain| + atol * max|plain| per output
# (dbv, whose true value is 0, against max|dv|): f32 sums of up to 100k terms
# in another order; bf16 outputs rounded once on each side, ~2.5 ulps
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
TRAIN_ROWS, SMALL_ROWS, TRAIN_STEPS, LR = 512, 16, 20, 5e-4
RL_ROWS, RL_ITERS, RL_LR = 256, 10, 5e-5  # bench.py::bench_rl's batch, optim_rl_lr
COCO_TRAIN_IMAGES = 113_287


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def flagship(torch_rfnet):
    """bench.py::flagship widths, tied-keys default profile."""
    return torch_rfnet(
        vocab_size=9487, seq_length=16,
        fc_feat_sizes=(2048, 1536, 2048, 2208, 1536),
        att_feat_sizes=(2048, 1536, 1280, 2208, 1536),
        att_nums=(196, 64, 64, 49, 64),
        rnn_size=512, input_encoding_size=512, att_hid_size=512,
        num_review_steps=8, num_review_steps_0=8, top_words_count=1000,
        tied_att_keys=True)


def attention_sites(model):
    """(name, G, N, A, D, {path: launches}) of every forward call site of
    the serving path ("serve": per beam-3 batch) and the XE step ("train":
    per step). Stage I and II have the same shapes on both paths (BATCH ==
    TRAIN_ROWS); the decoder reads B * beam rows when serving and B rows,
    one more step, when training."""
    S0, S, L = model.num_review_steps_0, model.num_review_steps, model.seq_length
    sites = [(f"stage1_enc{j}", 1, BATCH, a, d, {"serve": S0, "train": S0})
             for j, (a, d) in enumerate(zip(model.att_nums, model.att_feat_sizes))]
    sites.append(("stage2", model.num_feat_array, BATCH, S, model.rnn_size,
                  {"serve": S, "train": S}))
    sites.append(("decoder_beam", 1, BATCH * BEAM, S, model.rnn_size, {"serve": L}))
    sites.append(("decoder_train", 1, TRAIN_ROWS, S, model.rnn_size, {"train": L + 1}))
    return sites


def per_path(sites, path):
    return sum(s[-1].get(path, 0) for s in sites)


def event_ms(torch, fn, input_sets, reps=20, repeats=5):
    """Median over `repeats` of the mean time of `reps` back-to-back calls
    between CUDA events, cycling through input sets that together exceed the
    50 MB L2 cache. Includes the host's launch gaps."""
    fn(*input_sets[0])
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(*input_sets[i % len(input_sets)])
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def device_ms(torch, fn, input_sets, reps=20, attempts=3):
    """Mean device time per call: the summed durations of the device
    activities (kernels, copies) that `reps` calls put on the card, from
    torch.profiler, so the host's launch gaps are not counted. None when
    the profiler records no device activity in `attempts` tries (it does so
    now and then). Printed beside ``queued_ms``: after phase 8's CLI runs it
    read up to 2.5x below the bytes' bound, so it is not the reported time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*input_sets[0])
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*input_sets[i % len(input_sets)])
            torch.cuda.synchronize()
        total_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / reps / 1e3
    log("timing: the profiler recorded no device time")
    return None


def queued_ms(torch, fn, input_sets, reps=20):
    """Mean device time per call of ``reps`` back-to-back calls queued
    behind a run of matmuls, so the host queues them while the card is
    still busy: the time between CUDA events just after the matmuls and
    after the last call, which counts the card's own gaps between kernels
    but none of the host's. A longer run of matmuls where the host had not
    queued every call before the run ended."""
    fn(*input_sets[0])
    x = torch.randn(2048, 2048, device=DEVICE)
    torch.cuda.synchronize()
    for depth in (16, 64, 256):  # 2048^3 f32 products, about 0.3 ms each
        for _ in range(depth):
            torch.mm(x, x)
        head = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        head.record()
        start.record()
        for i in range(reps):
            fn(*input_sets[i % len(input_sets)])
        end.record()
        queued_in_time = not head.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
    raise AssertionError("timing: the host did not queue the calls within 256 matmuls")


def site_times(torch, kernel, plain, sets):
    """ms and plain_ms as ``queued_ms`` gives them, beside the profiler's
    kernel time of each (None where it recorded none) and the CUDA-event
    time of the kernel with the host's launch gaps."""
    return dict(ms=queued_ms(torch, kernel, sets),
                plain_ms=queued_ms(torch, plain, sets, reps=5),
                profiler_ms=device_ms(torch, kernel, sets),
                profiler_plain_ms=device_ms(torch, plain, sets, reps=5),
                event_ms=event_ms(torch, kernel, sets))


def check_attention_kernel(torch, aa, sites, dtypes):
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    results = []
    for dtype in dtypes:
        dname = str(dtype).replace("torch.", "")
        for name, G, N, A, D, launches in sites:
            def make():
                def r(*shape, scale=1.0):
                    x = torch.randn(*shape, generator=gen, device=DEVICE) * scale
                    return x.to(dtype)
                return (r(G * N, HID), r(G * N, A, HID), r(G, HID, scale=0.06),
                        r(G, scale=0.06), r(G * N, A, D))

            ins = make()
            z, w = aa.additive_attention(*ins)
            z2, w2 = aa.additive_attention(*ins)
            torch.cuda.synchronize()
            repeat = torch.equal(z, z2) and torch.equal(w, w2)
            zr, wr = aa.additive_attention_ref(*ins)
            tol = TOL[dname]
            err = max((z.float() - zr.float()).abs().max().item(),
                      (w.float() - wr.float()).abs().max().item())
            # relative to the largest reference value of the output
            rel = max((z.float() - zr.float()).abs().max().item()
                      / zr.float().abs().max().item(),
                      (w.float() - wr.float()).abs().max().item()
                      / wr.float().abs().max().item())
            ok = (torch.allclose(z.float(), zr.float(), **tol)
                  and torch.allclose(w.float(), wr.float(), **tol))
            esize = ins[0].element_size()
            nbytes = (sum(t.numel() for t in ins) + z.numel() + w.numel()) * esize
            ops = G * N * A * (4 * HID + 2 * D + 3)
            n_sets = max(1, min(8, -(-200_000_000 // nbytes)))
            sets = [ins] + [make() for _ in range(n_sets - 1)]
            times = site_times(torch, aa.additive_attention, aa.additive_attention_ref, sets)
            ms, plain_ms = times["ms"], times["plain_ms"]
            bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
            row = dict(site=name, dtype=dname, shape=[G, N, A, HID, D],
                       launches=launches, max_abs_err=err, max_rel_err=rel, ok=ok,
                       bitwise_repeat=repeat, **times, bound_ms=bound_ms,
                       bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                       else "operations", bytes=nbytes, gb_per_s=nbytes / ms / 1e6)
            log(f"kernel additive_attention_fwd {name} {dname} G={G} N={N} A={A} "
                f"D={D}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                f"(rtol {tol['rtol']}, atol {tol['atol']}) ok={ok} bitwise repeat={repeat} "
                f"ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
                f"bound/ms {bound_ms / ms:.3f} {row['gb_per_s']:.1f} GB/s "
                f"(profiler: {times['profiler_ms']} / plain {times['profiler_plain_ms']} ms; "
                f"events incl. launch gaps: {times['event_ms']:.4f} ms)")
            if not (ok and repeat):
                raise AssertionError(f"additive_attention_fwd disagrees at {name} {dname}")
            results.append(row)
            del sets, ins, z, w, z2, w2, zr, wr
    return results


def features(torch, model, batch, gen, dtype):
    from recurrent_fusion_network_torch.decoding.http_serve import feature_shapes

    fc_dims, att_shapes = feature_shapes(model)
    fcs = [torch.randn(batch, d, generator=gen, device=DEVICE).to(dtype) for d in fc_dims]
    atts = [torch.randn(batch, a, d, generator=gen, device=DEVICE).to(dtype)
            for a, d in att_shapes]
    return fcs, atts


def check_plain_vs_kernel_tokens(torch, model, params, what="slice"):
    from unittest import mock

    from recurrent_fusion_network_torch.decoding.api import model_sample
    from recurrent_fusion_network_torch.kernels import additive_attention as aa
    from recurrent_fusion_network_torch.ops import attention

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    fcs, atts = features(torch, model, 8, gen, torch.float32)
    with torch.inference_mode():
        k = model_sample(model, params, fcs, atts, beam_size=BEAM)
        with mock.patch.object(attention, "additive_attention", aa.additive_attention_ref):
            p = model_sample(model, params, fcs, atts, beam_size=BEAM)
    if not torch.equal(k.top_seq, p.top_seq):
        raise AssertionError("f32 beam-3 tokens differ between kernel and plain paths")
    lp_err = (k.top_p - p.top_p).abs().max().item()
    if not torch.allclose(k.top_p, p.top_p, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"f32 beam-3 top_p differ: {lp_err}")
    log(f"{what} f32 beam-3 (B=8): tokens identical with and without the kernel, "
        f"top_p max abs diff {lp_err:.3e}")


def serve_over_http(torch, model, params, counters, per_batch=64, what="slice"):
    import http.client

    import numpy as np

    from recurrent_fusion_network_torch.decoding.http_serve import (
        CaptionService,
        feature_shapes,
        run_server,
    )
    from recurrent_fusion_network_torch.training.checkpoint import cast_tree

    vocab = {str(i + 1): f"w{i + 1}" for i in range(model.vocab_size)}
    svc = CaptionService(model, cast_tree(params, torch.bfloat16), vocab,
                         device=DEVICE, batch_size=SERVE_BATCH, beam_size=BEAM)
    httpd = None
    try:
        svc.warmup()
        httpd = run_server(svc, "127.0.0.1", 0)
        port = httpd.server_address[1]
        rng = np.random.default_rng(3)
        bodies = []
        fc_dims, att_shapes = feature_shapes(model)
        for _ in range(N_REQUESTS):
            buf = io.BytesIO()
            np.savez(buf, **{f"fc_{i}": rng.standard_normal(d).astype(np.float32)
                             for i, d in enumerate(fc_dims)},
                     **{f"att_{i}": rng.standard_normal(shape).astype(np.float32)
                        for i, shape in enumerate(att_shapes)})
            bodies.append(buf.getvalue())
        replies = [None] * N_REQUESTS

        def client(i):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                conn.request("POST", "/caption", body=bodies[i],
                             headers={"Content-Type": "application/x-npz"})
                r = conn.getresponse()
                replies[i] = (r.status, json.loads(r.read()))
                conn.close()
            except Exception as e:  # recorded, then judged below
                replies[i] = (None, repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(N_REQUESTS)]
        for c in counters:
            c.launches = c.bwd_launches = c.scalar_launches = 0  # main path starts here
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
        if any(c.bwd_launches for c in counters):
            raise AssertionError("serving launched the backward kernel")
        if any(c.scalar_launches for c in counters):
            raise AssertionError("serving took the kernel's scalar path (unaligned inputs)")
        stats = dict(svc.server.stats)
    finally:
        if httpd is not None:
            httpd.shutdown()
        svc.close()
        if httpd is not None:
            httpd.server_close()
    bad = [r for r in replies if r is None or r[0] != 200 or not r[1].get("caption")
           or not np.isfinite(r[1].get("logprob", float("nan")))]
    log(f"{what} http: {N_REQUESTS} concurrent /caption requests in {wall:.3f} s, "
        f"{N_REQUESTS - len(bad)} answered 200 with a caption; server stats {stats}; "
        f"example {replies[0][1] if replies[0] else None}")
    if bad:
        raise AssertionError(f"{len(bad)} bad HTTP replies, e.g. {bad[0]}")
    if stats["requests"] != N_REQUESTS or stats["padded_rows"] == 0:
        raise AssertionError(f"expected {N_REQUESTS} requests incl. a partial batch: {stats}")
    if launches["additive_attention"] != per_batch * stats["batches"]:
        raise AssertionError(
            f"additive_attention_fwd launched {launches['additive_attention']} times "
            f"for {stats['batches']} batches (expected {per_batch} per batch)")
    log(f"{what} launches: {launches} over {stats['batches']} batches "
        f"({per_batch} additive_attention_fwd launches per batch)")
    return launches, dict(stats, wall_s=wall)


def throughput(torch, model, params, card, what="throughput"):
    """Timed B = 512 beam-3 bf16 decodes through pipelined_map, then one
    profiled decode: device busy time by kernel and the device's idle share.
    -> (captions/s, ms per batch, idle share or None)."""
    from torch.profiler import ProfilerActivity, profile

    from recurrent_fusion_network_torch.decoding.api import model_sample
    from recurrent_fusion_network_torch.decoding.serve import pipelined_map
    from recurrent_fusion_network_torch.training.checkpoint import cast_tree

    p16 = cast_tree(params, torch.bfloat16)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    batches = [features(torch, model, BATCH, gen, torch.bfloat16) for _ in range(2)]
    n_timed = 8

    def decode(batch):
        with torch.inference_mode():
            return model_sample(model, p16, *batch, beam_size=BEAM).seq

    decode(batches[0]).cpu()  # warm the allocator and caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # raises on any host sync
    try:
        seq = decode(batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    seq.cpu()
    log(f"{what}: a B=512 decode queued under sync debug mode 'error': "
        "no host sync inside the decode")
    t0 = time.perf_counter()
    n = 0
    for _, seq in pipelined_map(decode, (batches[i % 2] for i in range(n_timed)), depth=2):
        n += seq.cpu().shape[0]
    dt = time.perf_counter() - t0
    rate = n / dt
    log(f"{what}: {rate:.1f} captions/s (beam 3, bf16, B={BATCH}, {n_timed} "
        f"batches through pipelined_map depth 2, {dt:.4f} s, "
        f"{dt / n_timed * 1e3:.2f} ms per batch) on {card}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        decode(batches[1]).cpu()
        wall_ms = (time.perf_counter() - t1) * 1e3
    summary = device_profile(prof)
    batch_ms = dt / n_timed * 1e3
    if summary is None:
        log(f"{what} profile: the profiler recorded no device events; device time not "
            f"measured")
        return rate, batch_ms, None
    busy, n_events, by_name = summary
    log(f"{what} profile: one B={BATCH} beam-3 bf16 decode: wall {wall_ms:.2f} ms, device "
        f"busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}, {n_events} device events")
    for name, ms in by_name[:8]:
        log(f"{what} profile:   {ms:8.3f} ms  {name[:110]}")
    return rate, batch_ms, 1 - busy / wall_ms


def device_profile(prof):
    """-> (device busy ms, device events, [(name, ms)] by total time) of a
    torch.profiler run, or None when it recorded no device activity. Busy
    time is the union of the device activities' intervals."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for s0, e0, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0)
        if cur_e is None or s0 > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy = (busy + cur_e - cur_s) / 1e3
    top = sorted(((name, us / 1e3) for name, us in by_name.items()), key=lambda kv: -kv[1])
    return busy, len(spans), top


def train_sites(model, rows, path="train", prefix=""):
    """(name, G, N, A, D, values need a grad, {path: launches per step}) of
    every attention call site of the tied-keys XE step at ``rows``; the
    SCST step (path "scst") has the same sites."""
    S0, S, T = model.num_review_steps_0, model.num_review_steps, model.seq_length + 1
    sites = [(f"{prefix}stage1_enc{j}", 1, rows, a, d, False, {path: S0})
             for j, (a, d) in enumerate(zip(model.att_nums, model.att_feat_sizes))]
    sites.append((f"{prefix}stage2", model.num_feat_array, rows, S, model.rnn_size, True,
                  {path: S}))
    sites.append((f"{prefix}decoder", 1, rows, S, model.rnn_size, True, {path: T}))
    return sites


def _bwd_err(got, ref, tol):
    """(max abs err, max err / max|ref|, within tolerance) over the outputs
    (dq, dkeys, dvalues, dv, dbv); dbv is held against max|dv|."""
    abs_err, rel_err, ok = 0.0, 0.0, True
    dv_scale = ref[3].float().abs().max().item()
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            ok = ok and g is None
            continue
        g, r = g.float(), r.float()
        scale = max(r.abs().max().item(), dv_scale if i == 4 else 0.0, 1e-30)
        err = (g - r).abs()
        abs_err = max(abs_err, err.max().item())
        rel_err = max(rel_err, err.max().item() / scale)
        ok = ok and bool((err <= tol["rtol"] * r.abs() + tol["atol"] * scale).all())
    return abs_err, rel_err, ok


def check_attention_backward(torch, aa, sites, dtypes):
    """additive_attention_bwd vs additive_attention_bwd_ref at every given
    training site and dtype: errors, a bitwise repeat, device / event /
    plain ms and the bound. dz is random, w the forward's, the incoming
    grad of w None (the cells discard w)."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    results = []
    for dtype in dtypes:
        dname = str(dtype).replace("torch.", "")
        for name, G, N, A, D, need_dvalues, launches in sites:
            def make():
                def r(*shape, scale=1.0):
                    x = torch.randn(*shape, generator=gen, device=DEVICE) * scale
                    return x.to(dtype)
                q, keys, v, bv, values = (r(G * N, HID), r(G * N, A, HID),
                                          r(G, HID, scale=0.06), r(G, scale=0.06),
                                          r(G * N, A, D))
                _, w = aa.additive_attention_ref(q, keys, v, bv, values)
                return (r(G * N, D), None, q, keys, v, values, w)

            def kernel(*ins):
                return aa.additive_attention_bwd(*ins, need_dvalues=need_dvalues)

            def plain(*ins):
                return aa.additive_attention_bwd_ref(*ins, need_dvalues=need_dvalues)

            ins = make()
            got = kernel(*ins)
            again = kernel(*ins)
            torch.cuda.synchronize()
            repeat = all(a is b or torch.equal(a, b) for a, b in zip(got, again))
            ref = plain(*ins)
            tol = BWD_TOL[dname]
            err, rel, ok = _bwd_err(got, ref, tol)
            esize = ins[0].element_size()
            n_in = sum(t.numel() for t in ins if t is not None)
            n_out = sum(t.numel() for t in got if t is not None)
            nbytes = (n_in + n_out) * esize
            ops = G * N * A * (9 * HID + (3 if need_dvalues else 2) * D)
            n_sets = max(1, min(8, -(-200_000_000 // nbytes)))
            sets = [ins] + [make() for _ in range(n_sets - 1)]
            times = site_times(torch, kernel, plain, sets)
            ms, plain_ms = times["ms"], times["plain_ms"]
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
            row = dict(site=name, dtype=dname, shape=[G, N, A, HID, D],
                       dvalues=need_dvalues, launches=launches,
                       max_abs_err=err, max_rel_err=rel, ok=ok, bitwise_repeat=repeat,
                       **times,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                       bytes=nbytes, gb_per_s=nbytes / ms / 1e6)
            log(f"kernel additive_attention_bwd {name} {dname} G={G} N={N} A={A} D={D} "
                f"dvalues={need_dvalues}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                f"(rtol {tol['rtol']}, atol {tol['atol']} x max|plain|) ok={ok} "
                f"bitwise repeat={repeat} ms {ms:.4f} plain_ms {plain_ms:.4f} "
                f"bound_ms {row['bound_ms']:.4f} bound/ms {row['bound_ms'] / ms:.3f} "
                f"{row['gb_per_s']:.1f} GB/s (profiler: {times['profiler_ms']} / plain "
                f"{times['profiler_plain_ms']} ms; events incl. launch gaps: "
                f"{times['event_ms']:.4f} ms)")
            if not (ok and repeat):
                raise AssertionError(f"additive_attention_bwd disagrees at {name} {dname}")
            results.append(row)
            del sets, ins, got, again, ref
    return results


class FixedBatchLoader:
    """A loader for train() and train_rl(): the same batch of seeded random
    numpy arrays at the model's widths on every call, in the loader's
    batch-dict layout; one image per row, each with 5 random reference
    captions of seq_length tokens (``gts``)."""

    def __init__(self, model, rows, seed):
        import numpy as np

        from recurrent_fusion_network_torch.decoding.http_serve import feature_shapes

        rng = np.random.default_rng(seed)
        # the loader's top-word targets (--top_words_count, 1000 by default)
        # whether or not the model has a reason head
        L, V, W = model.seq_length, model.vocab_size, getattr(model, "top_words_count", 1000)
        self.vocab_size, self.seq_length = V, L
        # 4 captions over 50 words, each row one of them, its top words the
        # caption's words: a batch the model can fit, so the loss must fall
        caps = [rng.integers(1, 51, int(rng.integers(8, L + 1))) for _ in range(4)]
        labels = np.zeros((rows, L + 2), np.int64)
        masks = np.zeros((rows, L + 2), np.float32)
        top = np.full((rows, W), -1, np.int64)
        for r in range(rows):
            cap = caps[r % 4]
            labels[r, 1:len(cap) + 1] = cap
            masks[r, :len(cap) + 2] = 1.0
            words = np.unique(cap - 1)
            top[r, :len(words)] = words
        fc_dims, att_shapes = feature_shapes(model)
        fcs = [rng.standard_normal((rows, d), np.float32) for d in fc_dims]
        atts = [rng.standard_normal((rows,) + shape, np.float32) for shape in att_shapes]
        self.batch = {
            "labels": labels, "masks": masks, "top_words": top,
            "bounds": {"it_pos_now": 0, "it_max": rows, "wrapped": False},
        }
        if len(fcs) > 1:
            self.batch.update(fc_feats_array=fcs, att_feats_array=atts)
        else:  # the loader's single-encoder layout
            self.batch.update(fc_feats=fcs[0], att_feats=atts[0])
        self.batch["gts"] = [rng.integers(1, V, (5, L)) for _ in range(rows)]

    def get_batch(self, split):
        if split != "train":
            raise ValueError(f"only the train split: {split}")
        return self.batch


class GradSpy:
    """Wraps the port's optimizer and keeps the grads of its first update."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        if self.grads is None:
            from recurrent_fusion_network_torch.ops.initializers import tree_map

            self.grads = tree_map(lambda g: g.detach().clone(), grads)
        return self.tx.update(grads, state, params)


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{path}[{i}]")
    else:
        yield path, tree


def _score_bias(path):
    # softmax is shift-invariant: the true gradient of every att_h_2_out.b
    # is 0 and both paths return rounding noise, which Adam turns into steps
    # of up to lr
    return "'att_h_2_out']['b']" in path


def check_grads(torch, grads, what):
    """Every grad leaf finite, and non-zero except the score biases."""
    n, bad = 0, []
    for path, g in _paths(grads):
        n += 1
        if not bool(torch.isfinite(g).all()) or (
                not _score_bias(path) and not bool((g != 0).any())):
            bad.append(path)
    if bad:
        raise AssertionError(f"{what}: {len(bad)} grad leaves zero or not finite, e.g. {bad[:5]}")
    log(f"train {what}: all {n} grad leaves finite and non-zero (score biases: finite)")
    return n


def train_opts(model, **over):
    """The options train() and train_rl() build ``model`` from."""
    from recurrent_fusion_network_torch.config import Options
    from recurrent_fusion_network_torch.decoding.http_serve import feature_shapes

    fc_dims, att_shapes = feature_shapes(model)
    feats = [{"fc_feat_size": f, "att_feat_size": d, "att_num": a}
             for f, (a, d) in zip(fc_dims, att_shapes)]
    if hasattr(model, "fc_feat_sizes"):
        arch = dict(caption_model="recurrent_fusion_model", att_hid_size=model.att_hid_size,
                    num_review_steps=model.num_review_steps,
                    num_review_steps_0=model.num_review_steps_0,
                    top_words_count=model.top_words_count, tied_att_keys=1)
    elif hasattr(model, "att_feat_size"):
        arch = dict(caption_model="review_net", att_hid_size=model.att_hid_size,
                    num_review_steps=model.num_review_steps,
                    top_words_count=model.top_words_count,
                    tied_att_keys=int(model.tied_att_keys), use_mos=int(model.use_mos),
                    num_expert=model.num_expert)
    else:
        arch = dict(caption_model="show_tell", num_layers=model.num_layers)
    return Options(feat_array_info=feats, rnn_size=model.rnn_size,
                   input_encoding_size=model.input_encoding_size,
                   vocab_size=model.vocab_size, seq_length=model.seq_length,
                   device=DEVICE, seed=0, losses_log_every=1,
                   save_checkpoint_every=10 ** 9, **arch, **over)


def check_train_kernel_vs_plain(torch, model):
    """f32 flagship step at SMALL_ROWS: 3 Adam steps with the kernels and 3
    with the plain versions patched in, from the same params. Held: the
    first step's grads leaf by leaf (rtol 2e-3 / atol 2e-5, score biases
    atol only), the 3 losses (rtol 1e-5), and the params after 3 steps:
    every element within 2 * lr * 3 (the most an Adam step whose sign flips
    can move it; elements whose grad is at rounding level get +-lr in
    either run) and all but a share 1e-4 within rtol 1e-4 / atol 1e-5."""
    from unittest import mock

    from recurrent_fusion_network_torch.kernels import additive_attention as aa
    from recurrent_fusion_network_torch.ops import attention
    from recurrent_fusion_network_torch.ops.initializers import tree_map
    from recurrent_fusion_network_torch.training.criterion import make_criterion
    from recurrent_fusion_network_torch.training.optim import make_optimizer
    from recurrent_fusion_network_torch.training.train_loop import (device_batch,
                                                                    make_train_step)

    opt = train_opts(model)
    batch = device_batch(FixedBatchLoader(model, SMALL_ROWS, 6).get_batch("train"), DEVICE)
    base = model.init_params(torch.Generator(device=DEVICE).manual_seed(7), device=DEVICE)
    runs = {}
    for path in ("kernel", "plain"):
        params = tree_map(torch.clone, base)
        spy = GradSpy(make_optimizer(opt))
        step = make_train_step(model, make_criterion(opt), spy)
        state = spy.init(params)
        losses = []
        with mock.patch.object(attention, "additive_attention",
                               aa.additive_attention if path == "kernel"
                               else aa.additive_attention_ref):
            before = (aa.launches, aa.bwd_launches)
            for _ in range(3):
                params, state, loss = step(params, state, *batch, LR, 0.0, None)
                losses.append(loss.item())
            used = (aa.launches - before[0], aa.bwd_launches - before[1])
        if path == "kernel":
            check_grads(torch, spy.grads, "f32 kernel step")
        runs[path] = (losses, params, used, spy.grads)
        del spy, state
    (kl, kp, kused, kg), (pl, pp, pused, pg) = runs["kernel"], runs["plain"]
    if kused != (3 * 65, 3 * 65) or pused != (0, 0):
        raise AssertionError(f"launches kernel path {kused}, plain path {pused}")
    bad_grads, worst_grad = [], 0.0
    for (path, a), (_, b) in zip(_paths(kg), _paths(pg)):
        rtol = 0.0 if _score_bias(path) else 2e-3
        share = ((a - b).abs() / (2e-5 + rtol * b.abs())).max().item()
        worst_grad = max(worst_grad, share)
        if share > 1:
            bad_grads.append(path)
    n_out, n_all, max_diff, max_bias = 0, 0, 0.0, 0.0
    for (path, a), (_, b) in zip(_paths(kp), _paths(pp)):
        d = (a - b).abs()
        n_all += d.numel()
        if _score_bias(path):
            max_bias = max(max_bias, d.max().item())
        else:
            max_diff = max(max_diff, d.max().item())
            n_out += int((d > 1e-5 + 1e-4 * b.abs()).sum())
    loss_ok = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(kl, pl))
    log(f"train f32 B={SMALL_ROWS}, 3 Adam steps: losses kernel {kl} plain {pl} (rtol "
        f"1e-5: {loss_ok}); first-step grads worst share of rtol 2e-3 / atol 2e-5 "
        f"{worst_grad:.3f}; params: {n_out} of {n_all} elements outside rtol 1e-4 / "
        f"atol 1e-5, max abs diff {max_diff:.3e}, score biases {max_bias:.3e} (bound "
        f"2 * lr * 3 = {6 * LR:.1e}); launches kernel path {kused}, plain path {pused}")
    if bad_grads or not loss_ok or max(max_diff, max_bias) > 6 * LR \
            or n_out > 1e-4 * n_all:
        raise AssertionError(f"f32 kernel and plain steps differ; grads at {bad_grads[:5]}")
    del runs, kp, pp, kg, pg, base
    torch.cuda.empty_cache()
    return dict(f32_losses_kernel=kl, f32_losses_plain=pl, f32_grad_worst_share=worst_grad,
                f32_params_outside=n_out, f32_params=n_all, f32_params_max_diff=max_diff)


def train_bf16(torch, model, card, counters, rows=TRAIN_ROWS, per_step=65, profile=True,
               what="train"):
    """bf16 steps at ``rows`` through train(): ``per_step`` launches of each
    kernel per step, a falling loss, step time (the mean, and the median
    and quartiles of the gaps between log lines past the first two), rows/s,
    peak memory; then, with ``profile``, one profiled step."""
    from recurrent_fusion_network_torch.training.train_loop import train

    loader = FixedBatchLoader(model, rows, 8)
    opt = train_opts(model, dtype="bfloat16")
    stamps = []

    def log_fn(line):
        stamps.append(time.perf_counter())
        log(f"{what}: {line}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = c.bwd_launches = c.scalar_launches = 0  # main path starts here
    t0 = time.perf_counter()
    infos = train(opt, loader, max_iterations=TRAIN_STEPS, log_fn=log_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"additive_attention_fwd": sum(c.launches for c in counters),
                "additive_attention_bwd": sum(c.bwd_launches for c in counters)}
    scalar = sum(c.scalar_launches for c in counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [infos["loss_history"][i] for i in range(TRAIN_STEPS)]
    if launches != {k: per_step * TRAIN_STEPS for k in launches}:
        raise AssertionError(f"{what}: launches {launches} over {TRAIN_STEPS} steps "
                             f"(expected {per_step} + {per_step} per step)")
    if scalar:
        raise AssertionError(f"{what} took the kernels' scalar path {scalar} times")
    falls = sum(b < a for a, b in zip(losses, losses[1:]))
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0] \
            or falls < 0.75 * (len(losses) - 1):
        raise AssertionError(f"{what}: bf16 loss did not fall: {losses}")
    # log line k comes after loss k is read: the window from line 2 to the
    # last is steady state (the first two lines carry warm-up)
    steady = [b - a for a, b in zip(stamps[2:], stamps[3:])]
    step_ms = (stamps[-1] - stamps[2]) / len(steady) * 1e3
    median_ms = statistics.median(steady) * 1e3
    quartiles = [q * 1e3 for q in statistics.quantiles(steady, n=4)[::2]]
    log(f"{what} bf16 B={rows}: {TRAIN_STEPS} steps through train() in {wall:.3f} s "
        f"(params init included); steady step {step_ms:.2f} ms (mean over the last "
        f"{len(steady)}; between log lines median {median_ms:.2f}, quartiles "
        f"{[round(q, 2) for q in quartiles]}, min {min(steady) * 1e3:.2f}, max "
        f"{max(steady) * 1e3:.2f}), "
        f"{rows / step_ms * 1e3:.1f} rows/s; peak memory {peak_gb:.2f} GB; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches} "
        f"({per_step} + {per_step} per step) on {card}")
    out = dict(launches=launches, step_ms=step_ms, step_median_ms=median_ms,
               step_quartiles_ms=quartiles, rows_per_s=rows / step_ms * 1e3,
               peak_gb=peak_gb, losses=losses)
    params = infos["final_params"]
    state = infos["final_opt_state"]
    del infos
    if profile:
        out.update(profile_train_step(torch, model, opt, loader, params, state))
    return out


def profile_train_step(torch, model, opt, loader, params, state):
    """One more bf16 step as train() runs it (batch fetch, copy to the card,
    the step, the loss read) under torch.profiler, after a step whose grads
    are checked leaf by leaf."""
    from torch.profiler import ProfilerActivity, profile

    from recurrent_fusion_network_torch.training.criterion import make_criterion
    from recurrent_fusion_network_torch.training.optim import make_optimizer
    from recurrent_fusion_network_torch.training.train_loop import (device_batch,
                                                                    make_train_step)

    spy = GradSpy(make_optimizer(opt))
    step = make_train_step(model, make_criterion(opt), spy, torch.bfloat16)
    gen = torch.Generator(device=DEVICE).manual_seed(9)

    def one():
        nonlocal params, state
        batch = device_batch(loader.get_batch("train"), DEVICE, torch.bfloat16)
        params, state, loss = step(params, state, *batch, LR, 0.0, gen)
        return float(loss)

    one()
    check_grads(torch, spy.grads, f"bf16 step B={TRAIN_ROWS}")
    spy.grads = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        one()
        wall_ms = (time.perf_counter() - t1) * 1e3
    summary = device_profile(prof)
    if summary is None:
        log("train profile: the profiler recorded no device events; not measured")
        return dict(profile_wall_ms=wall_ms)
    busy, n_events, by_name = summary
    top = by_name[:12]
    log(f"train profile: one bf16 B={TRAIN_ROWS} step (batch copy included): wall "
        f"{wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{n_events} device events")
    for name, ms in top:
        log(f"train profile:   {ms:8.3f} ms  {name[:110]}")

    # the same step with the batch already on the card: host dispatch and
    # device compute without the copy
    batch = device_batch(loader.get_batch("train"), DEVICE, torch.bfloat16)
    n = 5
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n):
        params, state, loss = step(params, state, *batch, LR, 0.0, gen)
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t1) / n * 1e3
    copy_ms = sum(ms for name, ms in by_name if name.startswith("Memcpy HtoD"))
    log(f"train: {n} bf16 B={TRAIN_ROWS} steps with the batch already on the card: "
        f"{resident_ms:.2f} ms per step; the profiled step's host-to-device copy of the "
        f"batch (pinned, side stream): {copy_ms:.2f} ms")
    return dict(profile_wall_ms=wall_ms, profile_busy_ms=busy,
                profile_events=n_events, resident_step_ms=resident_ms,
                copy_ms=copy_ms, profile_top=[(name[:80], ms) for name, ms in top])


# ---------------------------------------------------------------- 7. SCST


def cider_scorer():
    """bench.py::bench_rl's reward scorer: 1,000,000 random hashed document
    frequencies (a COCO-sized table), ref_len log(113287), and the native
    engine (it raises where it cannot be built)."""
    import numpy as np

    from recurrent_fusion_network_torch.rewards.cider_d import CiderD

    g = np.random.default_rng(0)
    df = {int(k): float(v) for k, v in zip(g.integers(1, 2 ** 62, 1_000_000),
                                           g.integers(1, 50, 1_000_000))}
    return CiderD(df, math.log(COCO_TRAIN_IMAGES), backend="native")


def scst_sites(model):
    """Forward and backward sites of one SCST iteration without PPO at
    RL_ROWS, f32, with their launches per iteration ({"scst": n}): the
    rollout encodes B rows and decodes 2B lanes (sampled + greedy), the
    step re-evaluates B rows with gradients."""
    S0, S, T = model.num_review_steps_0, model.num_review_steps, model.seq_length + 1
    fwd = [(f"scst_stage1_enc{j}", 1, RL_ROWS, a, d, {"scst": 2 * S0})
           for j, (a, d) in enumerate(zip(model.att_nums, model.att_feat_sizes))]
    fwd.append(("scst_stage2", model.num_feat_array, RL_ROWS, S, model.rnn_size,
                {"scst": 2 * S}))
    fwd.append(("scst_decoder_rollout", 1, 2 * RL_ROWS, S, model.rnn_size, {"scst": T}))
    fwd.append(("scst_decoder_step", 1, RL_ROWS, S, model.rnn_size, {"scst": T}))
    return fwd, train_sites(model, RL_ROWS, path="scst", prefix="scst_")


def first_token_flip(k_out, p_out):
    """None when two rollouts (SampleOut over the same lanes) record the same
    tokens; else (lane, step, kernel token a, plain token b, margin) at the
    first step where they differ. Before that step every lane saw the same
    tokens, so the kernel path chose a over b although the plain path's
    scores ranked b first: with the same draw noise g, the gap between the
    two perturbed scores is at most margin = (lk[a] - lk[b]) - (lp[a] -
    lp[b]) of the two paths' log-probs there (g = 0 on greedy lanes)."""
    diff = k_out.seq != p_out.seq
    if not bool(diff.any()):
        return None
    step = int(diff.any(0).nonzero()[0, 0])
    lane = int(diff[:, step].nonzero()[0, 0])
    a, b = int(k_out.seq[lane, step]), int(p_out.seq[lane, step])
    lk, lp = k_out.logprobs_all[lane, step], p_out.logprobs_all[lane, step]
    return lane, step, a, b, float((lk[a] - lk[b]) - (lp[a] - lp[b]))


def check_rl_kernel_vs_plain(torch, model, scorer):
    """An f32 SCST iteration at SMALL_ROWS with the kernels and with the
    plain versions patched in, from the same params and generator seed: the
    2B-lane rollouts' tokens (a flip must be a near-tie, margin < 1e-5),
    then one policy-gradient step of each path on the kernel path's tokens
    and rewards: loss rtol 1e-5, every grad leaf rtol 2e-3 / atol 2e-5
    (score biases atol only), the kernel path's grad leaves finite and
    non-zero."""
    from unittest import mock

    from recurrent_fusion_network_torch.decoding.sample import sample
    from recurrent_fusion_network_torch.kernels import additive_attention as aa
    from recurrent_fusion_network_torch.ops import attention
    from recurrent_fusion_network_torch.ops.initializers import tree_map
    from recurrent_fusion_network_torch.rewards.self_critical import compute_reward
    from recurrent_fusion_network_torch.training import train_rl_loop as rl
    from recurrent_fusion_network_torch.training.criterion import make_rl_criterion
    from recurrent_fusion_network_torch.training.optim import make_optimizer
    from recurrent_fusion_network_torch.training.train_loop import device_batch

    opt = train_opts(model)
    data = FixedBatchLoader(model, SMALL_ROWS, 10).get_batch("train")
    fc, att, _, _, top = device_batch(data, DEVICE)
    base = model.init_params(torch.Generator(device=DEVICE).manual_seed(11), device=DEVICE)
    fns = {"kernel": aa.additive_attention, "plain": aa.additive_attention_ref}
    outs, used = {}, {}
    for path, fn in fns.items():
        got = []

        def spy(*args, **kw):
            got.append(sample(*args, **kw))
            return got[-1]

        before = (aa.launches, aa.bwd_launches)
        with mock.patch.object(attention, "additive_attention", fn), \
                mock.patch.object(rl, "sample", spy):
            rl.make_rollout_fn(model)(base, fc, att,
                                      torch.Generator(device=DEVICE).manual_seed(12))
        torch.cuda.synchronize()
        used[path] = [aa.launches - before[0], aa.bwd_launches - before[1]]
        outs[path] = got[0]
    flip = first_token_flip(outs["kernel"], outs["plain"])
    if flip is None:
        log(f"scst f32 B={SMALL_ROWS}: sampled and greedy tokens of the 2B-lane rollout "
            f"identical with the kernels and with the plain versions")
    else:
        lane, step, a, b, margin = flip
        log(f"scst f32 B={SMALL_ROWS}: rollout tokens differ first at lane {lane} step "
            f"{step}: kernel {a}, plain {b}, log-prob margin {margin:.3e} (limit 1e-5)")
        if not abs(margin) < 1e-5:
            raise AssertionError(f"rollout token flip beyond a near-tie: {flip}")

    B = SMALL_ROWS
    seq, greedy = outs["kernel"].seq[:B], outs["kernel"].seq[B:]
    rewards = compute_reward(scorer, seq.cpu().numpy(), greedy.cpu().numpy(), data["gts"])
    reward = torch.as_tensor(rewards, dtype=torch.float32, device=DEVICE)
    runs = {}
    for path, fn in fns.items():
        params = tree_map(torch.clone, base)
        spy_tx = GradSpy(make_optimizer(opt))
        step, _ = rl.make_rl_step(model, make_rl_criterion(opt), spy_tx)
        state = spy_tx.init(params)
        before = (aa.launches, aa.bwd_launches)
        with mock.patch.object(attention, "additive_attention", fn):
            _, _, loss = step(params, state, fc, att, seq, reward, top, RL_LR,
                              torch.zeros_like(reward))
            loss = loss.item()
        used[path][0] += aa.launches - before[0]
        used[path][1] += aa.bwd_launches - before[1]
        if path == "kernel":
            check_grads(torch, spy_tx.grads, "f32 SCST kernel step")
        runs[path] = (loss, spy_tx.grads)
        del spy_tx, state, params
    if used != {"kernel": [130, 65], "plain": [0, 0]}:
        raise AssertionError(f"SCST launches (fwd, bwd) per path {used}")
    (kl, kg), (pl, pg) = runs["kernel"], runs["plain"]
    bad_grads, worst_grad = [], 0.0
    for (path, a), (_, b) in zip(_paths(kg), _paths(pg)):
        rtol = 0.0 if _score_bias(path) else 2e-3
        share = ((a - b).abs() / (2e-5 + rtol * b.abs())).max().item()
        worst_grad = max(worst_grad, share)
        if share > 1:
            bad_grads.append(path)
    loss_ok = abs(kl - pl) <= 1e-5 * abs(pl)
    n_reward = int((rewards[:, 0] != 0).sum())
    log(f"scst f32 B={SMALL_ROWS} step on the kernel path's rollout ({n_reward} of {B} "
        f"rewards non-zero): loss kernel {kl!r} plain {pl!r} (rtol 1e-5: {loss_ok}); grads "
        f"worst share of rtol 2e-3 / atol 2e-5 {worst_grad:.3f}; launches (fwd, bwd) "
        f"{used}")
    if bad_grads or not loss_ok:
        raise AssertionError(f"f32 SCST kernel and plain steps differ; grads at "
                             f"{bad_grads[:5]}")
    del runs, kg, pg, base
    torch.cuda.empty_cache()
    return dict(rl_token_flip=flip, rl_loss_kernel=kl, rl_loss_plain=pl,
                rl_grad_worst_share=worst_grad, rl_nonzero_rewards=n_reward)


def train_scst(torch, model, scorer, card, counters, overlap, per_iter=(130, 65),
               what="scst"):
    """RL_ITERS f32 SCST iterations at RL_ROWS through train_rl() on a fixed
    batch, with the launch counters reset just before and read just after:
    ``per_iter`` launches per iteration (forward, backward; RFNet's 130 +
    65), none on the kernels' scalar path,
    finite losses and rewards, sampled lanes unlike the greedy ones in at
    least half the rows; iteration time, images/s, peak memory."""
    from unittest import mock

    from recurrent_fusion_network_torch.training import train_rl_loop as rl

    loader = FixedBatchLoader(model, RL_ROWS, 14)
    opt = train_opts(model, rl_overlap=overlap)
    stamps, differ = [], []
    real = rl.compute_reward

    def reward_spy(scorer_, gen, greedy, gts, **kw):
        differ.append(float((gen != greedy).any(axis=1).mean()))
        return real(scorer_, gen, greedy, gts, **kw)

    def log_fn(line):
        stamps.append(time.perf_counter())
        log(f"{what}: {line}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = c.bwd_launches = c.scalar_launches = 0  # main path starts here
    t0 = time.perf_counter()
    with mock.patch.object(rl, "compute_reward", reward_spy):
        infos = rl.train_rl(opt, loader, scorer, max_iterations=RL_ITERS, log_fn=log_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"additive_attention_fwd": sum(c.launches for c in counters),
                "additive_attention_bwd": sum(c.bwd_launches for c in counters)}
    scalar = sum(c.scalar_launches for c in counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rewards = [infos["loss_history"][i] for i in range(RL_ITERS)]
    losses = [infos["train_loss_history"][i] for i in range(RL_ITERS)]
    if launches != {"additive_attention_fwd": per_iter[0] * RL_ITERS,
                    "additive_attention_bwd": per_iter[1] * RL_ITERS}:
        raise AssertionError(f"{what}: launches {launches} over {RL_ITERS} SCST iterations "
                             f"(expected {per_iter[0]} + {per_iter[1]} per iteration)")
    if scalar:
        raise AssertionError(f"{what} took the kernels' scalar path {scalar} times")
    if not all(map(math.isfinite, rewards + losses)):
        raise AssertionError(f"{what}: rewards {rewards} or losses {losses} not finite")
    if len(differ) != RL_ITERS or min(differ) < 0.5:
        raise AssertionError(f"{what}: sampled lanes equal the greedy ones too often: "
                             f"{differ}")
    steady = [b - a for a, b in zip(stamps[2:], stamps[3:])]
    iter_ms = (stamps[-1] - stamps[2]) / len(steady) * 1e3
    log(f"{what} f32 B={RL_ROWS} rl_overlap={overlap}: {RL_ITERS} iterations through "
        f"train_rl() in {wall:.3f} s (params init included); steady iteration "
        f"{iter_ms:.2f} ms (mean over the last {len(steady)}; between log lines min "
        f"{min(steady) * 1e3:.2f}, max {max(steady) * 1e3:.2f}), "
        f"{RL_ROWS / iter_ms * 1e3:.1f} images/s; peak memory {peak_gb:.2f} GB; mean "
        f"rewards {rewards}; losses {losses}; sampled lanes unlike greedy in a share "
        f"{min(differ):.3f}+ of rows; launches {launches} ({per_iter[0]} + {per_iter[1]} "
        f"per iteration) on {card}")
    return dict(launches=launches, iter_ms=iter_ms, images_per_s=RL_ROWS / iter_ms * 1e3,
                peak_gb=peak_gb, rewards=rewards, losses=losses,
                differ_min=min(differ)), infos


def scst_split_and_profile(torch, model, scorer, params, state, card):
    """Serial SCST iterations as bench.py::bench_rl times them, split into
    the batch copy, the rollout to the tokens' readback, the host reward
    (native CIDEr-D engine asserted) and the gradient step to its end; then
    one iteration under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from recurrent_fusion_network_torch.rewards.self_critical import compute_reward
    from recurrent_fusion_network_torch.training import train_rl_loop as rl
    from recurrent_fusion_network_torch.training.criterion import make_rl_criterion
    from recurrent_fusion_network_torch.training.optim import make_optimizer
    from recurrent_fusion_network_torch.training.train_loop import device_batch

    if scorer.engine != "native":
        raise AssertionError(f"CIDEr-D scores with its {scorer.engine} engine, not the native one")
    loader = FixedBatchLoader(model, RL_ROWS, 14)
    opt = train_opts(model)
    rollout = rl.make_rollout_fn(model)
    step, _ = rl.make_rl_step(model, make_rl_criterion(opt), make_optimizer(opt))
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    parts = {"copy_ms": [], "rollout_ms": [], "reward_host_ms": [], "grad_step_ms": []}

    def one():
        nonlocal params, state
        t0 = time.perf_counter()
        data = loader.get_batch("train")
        fc, att, _, _, top = device_batch(data, DEVICE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        seq, greedy = rollout(params, fc, att, gen)
        seq_np, greedy_np = seq.cpu().numpy(), greedy.cpu().numpy()
        t2 = time.perf_counter()
        rewards = compute_reward(scorer, seq_np, greedy_np, data["gts"])
        t3 = time.perf_counter()
        reward = torch.as_tensor(rewards, dtype=torch.float32, device=DEVICE)
        params, state, loss = step(params, state, fc, att, seq, reward, top, RL_LR,
                                   torch.zeros_like(reward))
        float(loss)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, a, b in (("copy_ms", t0, t1), ("rollout_ms", t1, t2),
                        ("reward_host_ms", t2, t3), ("grad_step_ms", t3, t4)):
            parts[k].append((b - a) * 1e3)
        return (t4 - t0) * 1e3

    one()  # warm
    for v in parts.values():
        v.clear()
    totals = [one() for _ in range(3)]
    split = {k: statistics.median(v) for k, v in parts.items()}
    log(f"scst serial split, f32 B={RL_ROWS} (medians of 3): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()) + f"; iteration {statistics.median(totals):.2f} "
        f"ms; reward engine {scorer.engine} on {card}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = one()
    out = dict(split, serial_iter_ms=statistics.median(totals), profile_wall_ms=wall_ms)
    summary = device_profile(prof)
    if summary is None:
        log("scst profile: the profiler recorded no device events; not measured")
        return out
    busy, n_events, by_name = summary
    top = by_name[:12]
    log(f"scst profile: one serial f32 B={RL_ROWS} iteration (batch copy included): wall "
        f"{wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{n_events} device events")
    for name, ms in top:
        log(f"scst profile:   {ms:8.3f} ms  {name[:110]}")
    out.update(profile_busy_ms=busy, profile_events=n_events,
               profile_top=[(name[:80], ms) for name, ms in top])
    return out


# ---------------------------------------------------------------- 8. drivers

DRIVER_IMAGES = {"train": 300, "val": 100, "test": 100}
DRIVER_VOCAB, DRIVER_CAPS = 9487, 5
DRIVER_FREE_GB = 25  # data set ~1.6 GB, up to three 5.4 GB triples at a time
DRIVER_STEPS = 20  # steps or iterations before a run's boundary
CAPTION_WORDS = ("a the man woman dog cat ball park street red blue green small large "
                 "sitting standing running holding wearing riding table chair tree sky "
                 "grass water food plate bike car sign window door hat shirt").split()


def write_driver_dataset(root, model, seed=0, flip_split=None):
    """A data set at the flagship widths, in the files Dataset.from_files
    and the packed feature stores read: cocotalk.json (9,487 words; 300 /
    100 / 100 train / val / test images), npz labels (5 captions x 16
    tokens per image, half their words from a caption lexicon), a top-words
    pickle, and per registry encoder a packed/ store of original_fc.npy and
    original_att.npy (seeded random f32); with ``flip_split``, flip_fc.npy
    and flip_att.npy too, whose rows of that split are written (the store
    indexes every image's row; the others stay holes of the file).
    -> (argv of the data flags, GB of features written)."""
    import pickle

    import numpy as np

    g = np.random.default_rng(seed)
    words = CAPTION_WORDS + [f"w{i}" for i in range(len(CAPTION_WORDS), DRIVER_VOCAB)]
    images, ids = [], []
    for split, n in DRIVER_IMAGES.items():
        for _ in range(n):
            ids.append(100_000 + len(ids))
            images.append({"id": ids[-1], "split": split, "file_path": f"{ids[-1]}.jpg"})
    L = model.seq_length
    labels = np.zeros((len(ids) * DRIVER_CAPS, L), np.int32)
    for r in range(labels.shape[0]):
        n = int(g.integers(8, L + 1))
        lexicon = g.random(n) < 0.5
        labels[r, :n] = np.where(lexicon, g.integers(1, len(CAPTION_WORDS) + 1, n),
                                 g.integers(1, DRIVER_VOCAB + 1, n))
    paths = {k: os.path.join(root, f) for k, f in (("input_json", "cocotalk.json"),
                                                   ("input_label_h5", "cocotalk_label.npz"),
                                                   ("top_words_path", "vocab_train.pkl"))}
    with open(paths["input_json"], "w") as f:
        json.dump({"ix_to_word": {str(i + 1): w for i, w in enumerate(words)},
                   "images": images}, f)
    np.savez(paths["input_label_h5"], labels=labels,
             label_start_ix=np.arange(len(ids)) * DRIVER_CAPS + 1,
             label_end_ix=np.arange(1, len(ids) + 1) * DRIVER_CAPS)
    with open(paths["top_words_path"], "wb") as f:
        pickle.dump({"words": words[:model.top_words_count]}, f)
    data_root = os.path.join(root, "features")
    flip_rows = None if not flip_split else [i for i, im in enumerate(images)
                                             if im["split"] == flip_split]
    n_bytes = write_packed_features(data_root, ids, g, flip_rows)
    argv = ["--caption_model", "recurrent_fusion_model", "--feature_type", "feat_array",
            "--data_root", data_root]
    for k, v in paths.items():
        argv += [f"--{k}", v]
    return argv, n_bytes / 1e9


def write_packed_features(data_root, ids, g, flip_rows=None):
    """Per registry encoder a packed/ store under ``data_root`` of seeded
    random f32 features (``g``, a numpy Generator): original_fc.npy and
    original_att.npy, and with ``flip_rows`` flip_fc.npy and flip_att.npy,
    of which those rows are written (the store indexes every image's row;
    the others stay holes of the file). -> bytes written."""
    import numpy as np

    from recurrent_fusion_network_torch import feat_registry

    n_bytes = 0
    for info in feat_registry.feat_array_info(data_root):
        store = os.path.join(data_root, info.name, "packed")
        os.makedirs(store)
        with open(os.path.join(store, "ids.json"), "w") as f:
            json.dump(ids, f)
        variants = [("original", range(len(ids)))]
        if flip_rows:
            variants.append(("flip", flip_rows))
        for variant, rows in variants:
            for kind, shape in (("fc", (info.fc_feat_size,)),
                                ("att", (info.att_num, info.att_feat_size))):
                arr = np.lib.format.open_memmap(
                    os.path.join(store, f"{variant}_{kind}.npy"), mode="w+",
                    dtype=np.float32, shape=(len(ids),) + shape)
                for lo in range(rows[0], rows[-1] + 1, 50):  # contiguous rows
                    hi = min(lo + 50, rows[-1] + 1)
                    arr[lo:hi] = g.standard_normal((hi - lo,) + shape, dtype=np.float32)
                arr.flush()
                n_bytes += arr.nbytes * len(rows) // len(ids)
                del arr
    return n_bytes


class DriverProbe:
    """Wraps the loader a CLI builds: the time of every train-split fetch,
    how long the host waited in it for the prefetch thread, and an event on
    the compute stream just before it (in the overlapped loops, the end of
    the step queued before the fetch), beside the index of the side-stream
    copy the fetch is followed by. Timed copies (device events and the
    host's time in the copy call) are switched on for the run."""

    def __init__(self, torch):
        from recurrent_fusion_network_torch.data import pinned

        self.torch = torch
        self.copier = pinned.copier(DEVICE)
        self.copier.timing = True
        self.copier.timings, self.copier.host_ms = [], []
        self.waits = []  # ms the host waited in each train fetch
        self.origin = torch.cuda.Event(enable_timing=True)
        self.origin.record()
        self.fetches = []  # (host time, compute-stream event, copy index)
        self.boundaries = []  # host (start, end) of every eval and triple write
        self.loaders = []  # the loaders the CLI built

    def wrap(self, build_loader):
        def build(*a, **kw):
            loader = build_loader(*a, **kw)
            self.loaders.append(loader)
            real = loader.get_batch

            def get_batch(split, *args, **kwargs):
                if split == "train":
                    ev = self.torch.cuda.Event(enable_timing=True)
                    ev.record()
                    t0 = time.perf_counter()
                    self.fetches.append((t0, ev, len(self.copier.timings)))
                    out = real(split, *args, **kwargs)
                    self.waits.append((time.perf_counter() - t0) * 1e3)
                    return out
                return real(split, *args, **kwargs)

            loader.get_batch = get_batch
            return loader

        return build

    def timed(self, fn):
        """``fn`` with its host interval recorded as a boundary."""
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.boundaries.append((t0, time.perf_counter()))

        return call

    def summary(self, skip=2):
        """Steady fetch-to-fetch ms: the median and quartiles of the gaps
        past the first ``skip``, leaving out every gap a boundary (eval or
        triple write) falls in; medians past the first fetch of the host's
        wait for the loader, the side-stream copy's device ms and the host's
        ms in the copy call (train batches); the mean share of each copy
        that ran while the step queued before it still computed."""
        self.torch.cuda.synchronize()
        events, self.copier.timings = self.copier.timings, []
        host_ms, self.copier.host_ms = self.copier.host_ms, []
        self.copier.timing = False
        gaps = [(b[0] - a[0]) * 1e3 for a, b in zip(self.fetches, self.fetches[1:])]
        steady = [g for k, (g, a, b) in enumerate(zip(gaps, self.fetches, self.fetches[1:]))
                  if k >= skip and not any(s < b[0] and e > a[0] for s, e in self.boundaries)]
        if len(steady) < 2:
            raise AssertionError(f"drivers: {len(steady)} steady gaps in {gaps}")
        copies, hosts, shares = [], [], []
        for k, (_, step_end, idx) in enumerate(self.fetches):
            if idx >= len(events):
                continue
            c0, c1 = (self.origin.elapsed_time(e) for e in events[idx])
            copies.append(c1 - c0)
            hosts.append(host_ms[idx])
            if k > 0 and c1 > c0:  # the first fetch has no step before it
                end = self.origin.elapsed_time(step_end)
                shares.append(max(0.0, min(c1, end) - c0) / (c1 - c0))
        med = lambda xs: statistics.median(xs[1:] or xs) if xs else None  # noqa: E731
        return dict(step_ms=statistics.median(steady),
                    step_quartiles_ms=statistics.quantiles(steady, n=4)[::2],
                    steady_gaps=len(steady), fetch_gaps_ms=gaps,
                    loader_wait_ms=med(self.waits), copy_ms=med(copies),
                    copy_host_ms=med(hosts),
                    copy_overlap_share=statistics.mean(shares) if shares else None)


class ShapeRecorder:
    """Counts the attention kernels' launches by shape while phase 8's runs
    go: inside ``run(name)`` both wrappers are wrapped (they launch nothing
    of their own), and each call on the card is counted under its shape (dtype, G,
    N, A, D, and for the backward whether it computes dvalues) and the
    run's name. Every shape is then checked against the plain version."""

    def __init__(self, aa):
        self.aa = aa
        self.fwd, self.bwd = {}, {}  # shape -> {run: launches}

    def _count(self, table, shape, run):
        runs = table.setdefault(shape, {})
        runs[run] = runs.get(run, 0) + 1

    @staticmethod
    def _shape(q, keys, v, values, mask, dw=None):
        if mask is not None or dw is not None or keys.shape[2] != HID:
            raise AssertionError(
                f"drivers: an attention call with a mask, an incoming grad of w or H = "
                f"{keys.shape[2]}, which the checks do not cover")
        G = v.shape[0]
        return (str(q.dtype).replace("torch.", ""), G, keys.shape[0] // G, keys.shape[1],
                values.shape[2])

    def totals(self, run):
        return (sum(r.get(run, 0) for r in self.fwd.values()),
                sum(r.get(run, 0) for r in self.bwd.values()))

    @contextlib.contextmanager
    def run(self, name):
        from unittest import mock

        aa = self.aa
        real_fwd, real_bwd = aa.additive_attention_fwd, aa.additive_attention_bwd

        def fwd(q, keys, v, bv, values, mask=None):
            out = real_fwd(q, keys, v, bv, values, mask)
            if q.device.type == DEVICE:
                self._count(self.fwd, self._shape(q, keys, v, values, mask), name)
            return out

        def bwd(dz, dw, q, keys, v, values, w, mask=None, *, need_dvalues=True):
            out = real_bwd(dz, dw, q, keys, v, values, w, mask, need_dvalues=need_dvalues)
            if q.device.type == DEVICE:
                shape = self._shape(q, keys, v, values, mask, dw) + (need_dvalues,)
                self._count(self.bwd, shape, name)
            return out

        with mock.patch.object(aa, "additive_attention_fwd", fwd), \
                mock.patch.object(aa, "additive_attention_bwd", bwd):
            yield


def check_driver_sites(torch, aa, recorder, groups):
    """Both kernels against their plain versions at every shape the
    recorded runs (phases 8 and 10) gave them, each in its own dtype, at the
    tolerances of phases 3 and 6 with a bitwise repeat; each row's launches
    per run and summed over each group of ``groups`` ({name: run names})."""
    def launches(runs):
        return dict(runs, **{g: sum(runs.get(r, 0) for r in names)
                             for g, names in groups.items()})

    fwd_rows, bwd_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        fwd = [(f"drivers_G{G}_N{N}_A{A}_D{D}", G, N, A, D, launches(runs))
               for (dt, G, N, A, D), runs in sorted(recorder.fwd.items()) if dt == dname]
        bwd = [(f"drivers_G{G}_N{N}_A{A}_D{D}", G, N, A, D, need, launches(runs))
               for (dt, G, N, A, D, need), runs in sorted(recorder.bwd.items()) if dt == dname]
        if fwd:
            fwd_rows += check_attention_kernel(torch, aa, fwd, (dtype,))
        if bwd:
            bwd_rows += check_attention_backward(torch, aa, bwd, (dtype,))
    return fwd_rows, bwd_rows


def reset_counters(counters):
    for c in counters:
        c.launches = c.bwd_launches = c.scalar_launches = 0  # main path starts here


def read_counters(counters, what):
    launches = (sum(c.launches for c in counters), sum(c.bwd_launches for c in counters))
    scalar = sum(c.scalar_launches for c in counters)
    if scalar:
        raise AssertionError(f"{what} took the kernels' scalar path {scalar} times")
    return launches


def check_stats(stats, what):
    names = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE")
    bad = [k for k in names if not (stats and k in stats and math.isfinite(stats[k]))]
    if bad:
        raise AssertionError(f"{what}: metrics {bad} missing or not finite in {stats}")
    return {k: stats[k] for k in names}


def triple_files(run_id, prefix="", best=True):
    """The file names the JAX package's tags give one run's triples."""
    return sorted(f"{prefix}{kind}_{run_id}_0{tag}.pkl" for kind in
                  ("model", "optimizer", "infos") for tag in ([""] + (["-best"] if best else [])))


def remove_files(ck, names):
    for name in names:
        os.remove(os.path.join(ck, name))


def run_driver(torch, cli, argv, counters, expect, what, recorder, run):
    """One CLI run under the probe and the shape recorder (as ``run``) with
    the launch counters reset just before and read just after; the metric
    time (language_eval) and the JSONL events of the run beside it."""
    from unittest import mock

    from recurrent_fusion_network_torch.training import eval_split
    from recurrent_fusion_network_torch.training.train_loop import Boundaries

    metric_s = []
    real_lang = eval_split.language_eval

    def timed_lang(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_lang(*a, **kw)
        finally:
            metric_s.append(time.perf_counter() - t0)

    probe = DriverProbe(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    t0 = time.perf_counter()
    with mock.patch.object(cli, "build_loader", probe.wrap(cli.build_loader)), \
            mock.patch.object(eval_split, "language_eval", timed_lang), \
            mock.patch.object(Boundaries, "evaluate", probe.timed(Boundaries.evaluate)), \
            mock.patch.object(Boundaries, "save", probe.timed(Boundaries.save)), \
            mock.patch.object(Boundaries, "write", probe.timed(Boundaries.write)), \
            recorder.run(run):
        out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters, what)
    if launches != expect or recorder.totals(run) != expect:
        raise AssertionError(f"{what}: launches (fwd, bwd) {launches}, by shape "
                             f"{recorder.totals(run)}, expected {expect}")
    sources = [(type(src).__name__, getattr(src, "engine", None))
               for loader in probe.loaders for src in loader.sources]
    return out, dict(probe.summary(), wall_s=wall, metric_s=metric_s, launches=launches,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9, sources=sources)


def jsonl(path, event):
    with open(path) as f:
        return [e for e in map(json.loads, f) if e["event"] == event]


def drivers(torch, model, card, counters, recorder):
    """Phase 8: the three CLIs on a flagship-width data set written to disk:
    XE (bf16, 100 images x 5 captions, 21 steps, a boundary at iteration 20
    with beam-3 eval, the metrics and the triples), eval of the best triple
    on the test split, then SCST (f32, 51 images x 5) warm-started from it,
    21 iterations with a boundary at 40, under --rl_overlap 1 and 0. Launch
    counts per path asserted, every launch's shape recorded, metrics
    finite, triples named as the JAX package names them."""
    import shutil
    import tempfile

    from recurrent_fusion_network_torch import eval as eval_cli
    from recurrent_fusion_network_torch import main as main_cli
    from recurrent_fusion_network_torch import main_rl as main_rl_cli

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    free_gb = shutil.disk_usage(build).free / 1e9
    if free_gb < DRIVER_FREE_GB:
        raise AssertionError(f"drivers: {free_gb:.1f} GB free under {build}, "
                             f"{DRIVER_FREE_GB} GB needed")
    root = tempfile.mkdtemp(prefix="drivers_", dir=build)
    try:
        return _drivers(torch, model, card, counters, recorder, root, eval_cli, main_cli,
                        main_rl_cli, free_gb)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def time_picklers(ck, run_id):
    """The best triple's optimizer file (the f32 Adam moments) written again
    with the checkpoint writer's pickler (the pure-Python one, which writes
    the optax class paths by name) and with the C pickler (the same objects
    under the port's class names), in the order Python, C, C, Python:
    -> ({pickler: [s, s]}, GB per file). Page-cache writes, as the
    checkpoint writer's."""
    import pickle

    from recurrent_fusion_network_torch.training import checkpoint

    state = checkpoint.load_optimizer(ck, run_id, 0, best=True)
    path = os.path.join(ck, "pickler_probe.pkl")
    times = {"python": [], "c": []}
    for name in ("python", "c", "c", "python"):
        pickler = checkpoint._JaxNamePickler if name == "python" else pickle.Pickler
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            pickler(f, protocol=4).dump(state)
        times[name].append(time.perf_counter() - t0)
        size = os.path.getsize(path)
        os.remove(path)
    return times, size / 1e9


def _drivers(torch, model, card, counters, recorder, root, eval_cli, main_cli, main_rl_cli,
             free_gb):
    from recurrent_fusion_network_torch.training.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    data_argv, data_gb = write_driver_dataset(root, model)
    log(f"drivers: data set of {data_gb:.2f} GB of features (300 / 100 / 100 images, "
        f"{DRIVER_VOCAB} words) written in {time.perf_counter() - t0:.2f} s; "
        f"{free_gb:.1f} GB were free")
    ck = os.path.join(root, "checkpoint")
    common = data_argv + ["--device", DEVICE, "--checkpoint_path", ck, "--eval_results_dir",
                          os.path.join(root, "eval_results"), "--val_images_use", "100",
                          "--beam_size", "3", "--language_eval", "1", "--seed", "0",
                          "--losses_log_every", "5"]
    out = {}

    # XE: steps 0..20, the boundary at 20 (one eval batch of 100 images)
    log_xe = os.path.join(root, "xe.jsonl")
    xe_steps, every, per_eval = DRIVER_STEPS + 1, DRIVER_STEPS, 65 + 64
    infos, xe = run_driver(
        torch, main_cli, common + ["--dtype", "bfloat16", "--batch_size", "100",
                                   "--seq_per_img", "5", "--save_checkpoint_every", str(every),
                                   "--max_iterations", str(xe_steps), "--id", "xe",
                                   "--json_log", log_xe],
        counters, (65 * xe_steps + per_eval, 65 * xe_steps), "drivers XE", recorder, "xe")
    [val] = jsonl(log_xe, "val")
    stats = check_stats(val, "drivers XE eval")
    if sorted(os.listdir(ck)) != triple_files("xe"):
        raise AssertionError(f"drivers XE files {sorted(os.listdir(ck))}")
    _, saved = load_checkpoint(ck, "xe", 0, best=True)
    if saved["iter"] != xe_steps or saved["opt"]["tied_att_keys"] != 1 or "rng_key" in saved:
        raise AssertionError(f"drivers XE best infos: iter {saved['iter']}, tied "
                             f"{saved['opt']['tied_att_keys']}, keys {sorted(saved)}")
    del infos["final_params"], infos["final_opt_state"], saved
    remove_files(ck, [f for f in triple_files("xe") if "-best" not in f])
    xe.update(eval_s=val["seconds"], metric_s=xe["metric_s"][0],
              decode_s=val["seconds"] - xe["metric_s"][0], triples_write_s=val["save_seconds"],
              stats=stats, losses=infos["loss_history"])
    log(f"drivers XE bf16 B=100x5: steady step {xe['step_ms']:.2f} ms, quartiles "
        f"{[round(q, 2) for q in xe['step_quartiles_ms']]} (fetch to fetch over "
        f"{xe['steady_gaps']} gaps past the first two and clear of the boundary: "
        f"{[round(g, 2) for g in xe['fetch_gaps_ms']]}); host "
        f"waited {xe['loader_wait_ms']:.2f} ms per fetch for the loader; batch copy on the "
        f"side stream {xe['copy_ms']:.2f} ms on the device, {xe['copy_host_ms']:.2f} ms of "
        f"host time to queue it, share of it under the step queued before "
        f"{xe['copy_overlap_share']:.3f}; boundary eval {xe['eval_s'] * 1e3:.1f} ms (decode "
        f"and loss {xe['decode_s'] * 1e3:.1f} ms, metrics {xe['metric_s'] * 1e3:.1f} ms), "
        f"two triples written in {xe['triples_write_s'] * 1e3:.1f} ms; metrics {stats}; "
        f"launches (fwd, bwd) {xe['launches']}; wall {xe['wall_s']:.2f} s; peak memory "
        f"{xe['peak_gb']:.2f} GB on {card}")
    out["xe"] = xe

    times, gb = time_picklers(ck, "xe")
    out["optimizer_write"] = dict(gb=gb, **{f"{k}_s": v for k, v in times.items()})
    log(f"drivers: the best optimizer file ({gb:.2f} GB) written with the checkpoint "
        f"writer's pure-Python pickler {[round(t, 3) for t in times['python']]} s, with the "
        f"C pickler {[round(t, 3) for t in times['c']]} s (order Python, C, C, Python) on "
        f"{card}")

    # eval of the XE best triple on the test split
    reset_counters(counters)
    t0 = time.perf_counter()
    with recorder.run("eval"):
        loss, preds, stats = eval_cli.main(
            ["--model_path", ck, "--load_model_id", "xe", "--eval_split", "test",
             "--val_images_use", "100", "--beam_size", "3", "--batch_size", "100",
             "--dtype", "bfloat16", "--eval_results_dir", os.path.join(root, "eval_results"),
             "--device", DEVICE] + data_argv)
    torch.cuda.synchronize()
    ev_wall = time.perf_counter() - t0
    launches = read_counters(counters, "drivers eval")
    if launches != (per_eval, 0) or recorder.totals("eval") != launches \
            or len(preds) != 100 or not math.isfinite(loss):
        raise AssertionError(f"drivers eval: launches {launches}, by shape "
                             f"{recorder.totals('eval')}, {len(preds)} predictions, loss {loss}")
    out["eval"] = dict(wall_s=ev_wall, loss=loss, stats=check_stats(stats, "drivers eval"),
                       launches=launches)
    log(f"drivers eval (test, 100 images, beam 3, bf16): loss {loss:.4f}, metrics "
        f"{out['eval']['stats']}; {ev_wall:.2f} s including the checkpoint read; launches "
        f"{launches} on {card}")

    # SCST from the XE best triple (iteration 21 on): 21 iterations, the
    # boundary at 40 (two eval batches of 51 images)
    rl_iters, rl_evals = DRIVER_STEPS + 1, 2
    for overlap in (1, 0):
        run_id, log_rl = f"rl{overlap}", os.path.join(root, f"rl{overlap}.jsonl")
        infos, rl = run_driver(
            torch, main_rl_cli,
            common + ["--batch_size", "51", "--seq_per_img", "5", "--dtype", "float32",
                      "--start_from", ck, "--load_model_id", "xe", "--id", run_id,
                      "--save_checkpoint_every", str(every),
                      "--max_iterations", str(xe_steps + rl_iters),
                      "--rl_overlap", str(overlap), "--json_log", log_rl,
                      "--cider_df", os.path.join(root, "absent.p")],
            counters, (130 * rl_iters + per_eval * rl_evals, 65 * rl_iters),
            f"drivers SCST rl_overlap={overlap}", recorder, f"scst_overlap_{overlap}")
        [val] = jsonl(log_rl, "rl_val")
        stats = check_stats(val, "drivers SCST eval")
        rewards = [e["avg_reward"] for e in jsonl(log_rl, "rl_train")]
        files = sorted(f for f in os.listdir(ck) if f.startswith("rl_"))
        if files not in (triple_files(run_id, "rl_"), triple_files(run_id, "rl_", False)):
            raise AssertionError(f"drivers SCST files {files}")
        remove_files(ck, files)
        if not all(map(math.isfinite, rewards)) or infos["iter"] != xe_steps + rl_iters:
            raise AssertionError(f"drivers SCST: iter {infos['iter']}, rewards {rewards}")
        del infos
        rl.update(eval_s=val["seconds"], triples_write_s=val["save_seconds"], stats=stats,
                  rewards=rewards, files=files)
        log(f"drivers SCST f32 B=51x5 rl_overlap={overlap}: steady iteration "
            f"{rl['step_ms']:.2f} ms, quartiles {[round(q, 2) for q in rl['step_quartiles_ms']]} "
            f"(fetch to fetch over {rl['steady_gaps']} gaps past the first two and clear of "
            f"the boundary: {[round(g, 2) for g in rl['fetch_gaps_ms']]}); loader wait "
            f"{rl['loader_wait_ms']:.2f} ms; batch copy on the side stream {rl['copy_ms']:.2f} "
            f"ms on the device, {rl['copy_host_ms']:.2f} ms of host time, share under the "
            f"step queued before {rl['copy_overlap_share']:.3f}; boundary eval "
            f"{rl['eval_s'] * 1e3:.1f} ms "
            f"(metrics {rl['metric_s'][0] * 1e3:.1f} ms), {len(files) // 3} triple(s) in "
            f"{rl['triples_write_s'] * 1e3:.1f} ms; rewards {rewards}; metrics {stats}; "
            f"launches {rl['launches']}; wall {rl['wall_s']:.2f} s; peak memory "
            f"{rl['peak_gb']:.2f} GB on {card}")
        out[f"scst_overlap_{overlap}"] = rl
    remove_files(ck, os.listdir(ck))  # the XE best triple
    on, off = out["scst_overlap_1"], out["scst_overlap_0"]
    log(f"drivers: SCST iteration rl_overlap=1 {on['step_ms']:.2f} ms (quartiles "
        f"{[round(q, 2) for q in on['step_quartiles_ms']]}), rl_overlap=0 "
        f"{off['step_ms']:.2f} ms (quartiles {[round(q, 2) for q in off['step_quartiles_ms']]}) "
        f"on {card}")
    return out


# ---------------------------------------------------------------- 9. models

MODEL_XE_ROWS = 500  # 100 images x 5 captions


def phase9_models():
    """The single-encoder models at their published widths (random weights
    from a seeded generator): ShowTell on the registry's resnet fc
    features, 1 layer; ReviewNet on inception_v3's, 8 review steps, with
    tied keys (the default), untied keys (--reference_parity) and the
    10-expert Mixture-of-Softmax head (--use_mos 1 --num_expert 10)."""
    from recurrent_fusion_network_torch import feat_registry
    from recurrent_fusion_network_torch.models import ReviewNetModel, ShowTellModel

    resnet = feat_registry.encoder_info("resnet", "unused")
    inception = feat_registry.encoder_info("inception_v3", "unused")
    common = dict(vocab_size=9487, seq_length=16, input_encoding_size=HID, rnn_size=HID)
    review = dict(common, att_hid_size=HID, fc_feat_size=inception.fc_feat_size,
                  att_feat_size=inception.att_feat_size, att_num=inception.att_num,
                  num_review_steps=8, top_words_count=1000)
    return {
        "show_tell": ShowTellModel(**common, num_layers=1, fc_feat_size=resnet.fc_feat_size),
        "review_net": ReviewNetModel(**review, tied_att_keys=True),
        "review_net_parity": ReviewNetModel(**review, tied_att_keys=False),
        "review_net_mos": ReviewNetModel(**review, tied_att_keys=True, use_mos=True,
                                         num_expert=10),
    }


def model_launches(model):
    """Launches of the forward kernel per beam-3 batch, of each kernel per
    XE step, and (forward, backward) per SCST iteration: ReviewNet reads
    attention once per review step (S) and once per decoder step (L beam
    steps, L + 1 teacher-forced or sampled steps); ShowTell never."""
    if not hasattr(model, "att_feat_size"):
        return 0, 0, (0, 0)
    S, T = model.num_review_steps, model.seq_length + 1
    return S + T - 1, S + T, (2 * (S + T), S + T)


def review_net_sites(model):
    """(forward sites, backward sites) of the ReviewNet paths phase 9
    drives, with their launches per path: beam-3 serving at BATCH images
    (per batch), the bf16 XE step at MODEL_XE_ROWS and the f32 SCST
    iteration at RL_ROWS (rollout over 2B lanes, then the step). The review
    cells' values are the input features (no gradient), the decoder's the
    thought vectors."""
    S, T, A, D, R = (model.num_review_steps, model.seq_length + 1, model.att_num,
                     model.att_feat_size, model.rnn_size)
    fwd = [("review_net_review_serve", 1, BATCH, A, D, {"review_net_serve": S}),
           ("review_net_decoder_beam", 1, BATCH * BEAM, S, R, {"review_net_serve": T - 1}),
           ("review_net_review_train", 1, MODEL_XE_ROWS, A, D, {"review_net_train": S}),
           ("review_net_decoder_train", 1, MODEL_XE_ROWS, S, R, {"review_net_train": T}),
           ("review_net_review_scst", 1, RL_ROWS, A, D, {"review_net_scst": 2 * S}),
           ("review_net_decoder_rollout", 1, 2 * RL_ROWS, S, R, {"review_net_scst": T}),
           ("review_net_decoder_step", 1, RL_ROWS, S, R, {"review_net_scst": T})]
    bwd = [("review_net_review_train", 1, MODEL_XE_ROWS, A, D, False, {"review_net_train": S}),
           ("review_net_decoder_train", 1, MODEL_XE_ROWS, S, R, True, {"review_net_train": T}),
           ("review_net_review_scst", 1, RL_ROWS, A, D, False, {"review_net_scst": S}),
           ("review_net_decoder_step", 1, RL_ROWS, S, R, True, {"review_net_scst": T})]
    return fwd, bwd


def drive_model(torch, aa, name, model, scorer, card):
    """Phase 9 for one model: (ReviewNet) f32 beam-3 tokens with the kernels
    equal to those with the plain versions; a bf16 CaptionService of batch
    16 behind the HTTP front end; B = 512 beam-3 captions/s; bf16 XE steps
    through train() at MODEL_XE_ROWS; f32 SCST iterations through
    train_rl() at RL_ROWS. The launch counters are reset just before and
    read just after each path, and must read model_launches' counts."""
    per_batch, per_step, per_iter = model_launches(model)
    params = model.init_params(torch.Generator(device=DEVICE).manual_seed(20), device=DEVICE)
    if per_batch:
        check_plain_vs_kernel_tokens(torch, model, params, what=name)
    launches, stats = serve_over_http(torch, model, params, [aa], per_batch=per_batch,
                                      what=f"{name} serve")
    rate, batch_ms, idle = throughput(torch, model, params, card, what=f"{name} throughput")
    del params
    torch.cuda.empty_cache()
    xe = train_bf16(torch, model, card, [aa], rows=MODEL_XE_ROWS, per_step=per_step,
                    profile=False, what=f"{name} xe")
    torch.cuda.empty_cache()
    scst, infos = train_scst(torch, model, scorer, card, [aa], overlap=1, per_iter=per_iter,
                             what=f"{name} scst")
    del infos
    torch.cuda.empty_cache()
    out = dict(serve=dict(launches=launches["additive_attention"], **stats),
               captions_per_s=rate, batch_ms=batch_ms, decode_idle_share=idle, xe=xe,
               scst=scst)
    log(f"models {name}: {rate:.1f} captions/s (B={BATCH} beam 3 bf16, {batch_ms:.2f} ms "
        f"per batch); XE bf16 B={MODEL_XE_ROWS} step median {xe['step_median_ms']:.2f} ms, "
        f"quartiles {[round(q, 2) for q in xe['step_quartiles_ms']]}, peak "
        f"{xe['peak_gb']:.2f} GB; SCST f32 B={RL_ROWS} iteration {scst['iter_ms']:.2f} ms, "
        f"{scst['images_per_s']:.1f} images/s, peak {scst['peak_gb']:.2f} GB; launches "
        f"serve {launches['additive_attention']} over {stats['batches']} batches, XE "
        f"{xe['launches']}, SCST {scst['launches']} on {card}")
    return out


def models_phase(torch, aa, scorer, card):
    """Phase 9: both kernels against their plain versions at ReviewNet's
    sites (f32 and bf16; the three ReviewNet variants give the kernels the
    same shapes), then every model's paths (``drive_model``). -> (forward
    site rows, backward site rows, {model: its results})."""
    t0 = time.perf_counter()
    models = phase9_models()
    fwd_sites, bwd_sites = review_net_sites(models["review_net"])
    per_batch, per_step, per_iter = model_launches(models["review_net"])
    if (per_path(fwd_sites, "review_net_serve"), per_path(fwd_sites, "review_net_train"),
            per_path(bwd_sites, "review_net_train"), per_path(fwd_sites, "review_net_scst"),
            per_path(bwd_sites, "review_net_scst")) != (per_batch, per_step, per_step,
                                                        *per_iter):
        raise AssertionError("models: ReviewNet's sites do not add up to its launches")
    rows = check_attention_kernel(torch, aa, fwd_sites, (torch.float32, torch.bfloat16))
    bwd_rows = check_attention_backward(torch, aa, bwd_sites, (torch.float32, torch.bfloat16))
    driven = {name: drive_model(torch, aa, name, model, scorer, card)
              for name, model in models.items()}
    log(f"models: phase 9 in {time.perf_counter() - t0:.2f} s")
    return rows, bwd_rows, driven


def models_sums(rows, bwd_rows, driven):
    """Phase 9's entries of the kernels JSON: the forward and backward
    site sums per ReviewNet path (serving and XE in bf16, SCST in f32), and
    each kernel's launches per model and path from the counters of its
    runs."""
    def sums(site_rows, path, dtype):
        out = path_sums([r for r in site_rows if r["dtype"] == dtype], path)
        return dict(out, dtype=dtype)

    fwd = {p: sums(rows, p, dt) for p, dt in (("review_net_serve", "bfloat16"),
                                              ("review_net_train", "bfloat16"),
                                              ("review_net_scst", "float32"))}
    bwd = {p: sums(bwd_rows, p, dt) for p, dt in (("review_net_train", "bfloat16"),
                                                  ("review_net_scst", "float32"))}
    model_fwd, model_bwd = {}, {}
    for name, d in driven.items():
        model_fwd[f"{name}_serve"] = d["serve"]["launches"]
        for path, run in (("train", d["xe"]), ("scst", d["scst"])):
            model_fwd[f"{name}_{path}"] = run["launches"]["additive_attention_fwd"]
            model_bwd[f"{name}_{path}"] = run["launches"]["additive_attention_bwd"]
    return fwd, bwd, model_fwd, model_bwd


# --------------------------------------------------------------- 10. fleets

FLEET_SEEDS = 4
FLEET_XE_EVERY = 10  # XE steps 0..10, the boundary at 10
FLEET_RL_ITERS = 6  # SCST iterations from the XE best triples' iter 11, the boundary at 16
FLEET_FREE_GB = 60  # data set ~2 GB; 4 XE triples, 4 rl_ triples and up to 4 rl_ best
ENSEMBLE_TIMED = 4  # B = 512 ensemble batches timed
PHASE10_RUNS = ("fleet_xe", "fleet_scst", "ensemble_eval", "ensemble_flip",
                "ensemble_eval_repeat", "ensemble_throughput")


def fleet_files(run_id, n_seeds, prefix=""):
    """The rolling and best triples' names of every seed of a fleet."""
    return sorted(f"{prefix}{kind}_{run_id}_{r}{tag}.pkl" for r in range(n_seeds)
                  for kind in ("model", "optimizer", "infos") for tag in ("", "-best"))


def host_state():
    """(GB of host memory available, GB free on the build directory's disk)."""
    import shutil

    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) for line in f if line.startswith("MemAvailable"))
    return avail / 1e6, shutil.disk_usage(os.path.join(REPO, "build")).free / 1e9


def check_ensemble_tokens(torch, model, aa, counters):
    """A 2-member f32 flagship ensemble of two seeded random inits: its
    beam-3 tokens on 16 images with the kernel equal those with the plain
    version patched in, and the kernel's launches per batch are the
    members' solo counts added up (2 x 64)."""
    from unittest import mock

    from recurrent_fusion_network_torch.decoding.ensemble import ensemble_sample
    from recurrent_fusion_network_torch.ops import attention

    members = [model.init_params(torch.Generator(device=DEVICE).manual_seed(30 + i),
                                 device=DEVICE) for i in range(2)]
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    feats = [features(torch, model, 16, gen, torch.float32)] * 2
    with torch.inference_mode():
        reset_counters(counters)
        k = ensemble_sample([model] * 2, members, feats, beam_size=BEAM)
        launches = read_counters(counters, "ensemble check")
        with mock.patch.object(attention, "additive_attention", aa.additive_attention_ref):
            p = ensemble_sample([model] * 2, members, feats, beam_size=BEAM)
    if not torch.equal(k.top_seq, p.top_seq) or launches != (2 * 64, 0):
        raise AssertionError(f"ensemble: f32 beam-3 tokens differ between kernel and plain "
                             f"paths, or launches {launches} != (128, 0)")
    err = (k.top_p - p.top_p).abs().max().item()
    if not torch.allclose(k.top_p, p.top_p, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"ensemble: f32 beam-3 top_p differ: {err}")
    log(f"fleets: 2-member f32 flagship ensemble, beam 3, 16 images: tokens identical with "
        f"and without the kernel, top_p max abs diff {err:.3e}, {launches[0]} launches")
    return dict(tokens_equal=True, top_p_max_abs_diff=err, launches=launches)


def state_gb(model):
    """GB of one seed's f32 params and Adam moments on the card."""
    from recurrent_fusion_network_torch.ops.initializers import tree_leaves

    return 3 * 4 * sum(t.numel() for t in tree_leaves(model.init_params(None,
                                                                         device="meta"))) / 1e9


def fleet_summary(run, log_path, event, n_seeds, what, card):
    """The fleet run's boundary split (from its fleet_val events) beside the
    probe's iteration times; one log line."""
    vals = jsonl(log_path, "fleet_val")
    boundary, epilogue = vals[0], vals[-1]
    run.update(boundary_eval_s=boundary["seconds"], boundary_write_s=boundary["save_seconds"],
               epilogue_eval_s=epilogue["seconds"], ms_per_seed=run["step_ms"] / n_seeds,
               train_events=len(jsonl(log_path, event)))
    log(f"{what}: S={n_seeds} iteration {run['step_ms']:.2f} ms (median of "
        f"{run['steady_gaps']} fetch gaps clear of the boundary), quartiles "
        f"{[round(q, 2) for q in run['step_quartiles_ms']]}, {run['ms_per_seed']:.2f} ms per "
        f"seed; boundary: eval {boundary['seconds']:.2f} s over {n_seeds} seeds, triples "
        f"{boundary['save_seconds']:.2f} s; epilogue eval {epilogue['seconds']:.2f} s; "
        f"launches {run['launches']}; wall "
        f"{run['wall_s']:.2f} s; peak memory {run['peak_gb']:.2f} GB on {card}")
    return run


def run_ensemble_cli(torch, cli, argv, counters, expect, what, recorder, run):
    """The ensemble CLI under the shape recorder with the counters reset just
    before and read just after: wall seconds (checkpoint reads included),
    the eval_ensemble call's seconds, captions/s, metrics finite."""
    from unittest import mock

    timed = {}
    real = cli.eval_ensemble

    def eval_ensemble(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.synchronize()
            timed["eval_s"] = time.perf_counter() - t0

    reset_counters(counters)
    t0 = time.perf_counter()
    with mock.patch.object(cli, "eval_ensemble", eval_ensemble), recorder.run(run):
        preds, stats = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters, what)
    if launches != expect or recorder.totals(run) != expect or len(preds) != 100:
        raise AssertionError(f"{what}: launches {launches}, by shape {recorder.totals(run)}, "
                             f"expected {expect}; {len(preds)} predictions")
    return dict(wall_s=wall, eval_s=timed["eval_s"], captions_per_s=len(preds) / timed["eval_s"],
                stats=check_stats(stats, what), launches=launches)


def ensemble_throughput(torch, model, counters, recorder, card, solo_rate):
    """A 4-member bf16 ensemble (seeded random members) on B = 512 beam-3
    batches through pipelined_map: captions/s beside phase 5's solo rate,
    the counters reading 4 x 64 per batch."""
    from recurrent_fusion_network_torch.decoding.ensemble import ensemble_sample
    from recurrent_fusion_network_torch.decoding.serve import pipelined_map
    from recurrent_fusion_network_torch.training.checkpoint import cast_tree

    members = [cast_tree(model.init_params(torch.Generator(device=DEVICE).manual_seed(40 + i),
                                           device=DEVICE), torch.bfloat16)
               for i in range(FLEET_SEEDS)]
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    batches = [features(torch, model, BATCH, gen, torch.bfloat16) for _ in range(2)]

    def decode(batch):
        with torch.inference_mode():
            return ensemble_sample([model] * FLEET_SEEDS, members, [batch] * FLEET_SEEDS,
                                   beam_size=BEAM).seq

    reset_counters(counters)
    with recorder.run("ensemble_throughput"):
        decode(batches[0]).cpu()  # warm the allocator and caches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for _, seq in pipelined_map(decode, (batches[i % 2] for i in range(ENSEMBLE_TIMED)),
                                    depth=2):
            n += seq.cpu().shape[0]
        dt = time.perf_counter() - t0
    launches = read_counters(counters, "ensemble throughput")
    expect = (FLEET_SEEDS * 64 * (ENSEMBLE_TIMED + 1), 0)
    if launches != expect or recorder.totals("ensemble_throughput") != expect:
        raise AssertionError(f"ensemble throughput: launches {launches}, expected {expect}")
    rate = n / dt
    log(f"fleets: {FLEET_SEEDS}-member bf16 ensemble, beam 3, B={BATCH}: {rate:.1f} "
        f"captions/s ({dt / ENSEMBLE_TIMED * 1e3:.2f} ms per batch over {ENSEMBLE_TIMED} "
        f"batches through pipelined_map depth 2); the solo model {solo_rate:.1f} captions/s "
        f"(phase 5); launches {launches} on {card}")
    return dict(captions_per_s=rate, batch_ms=dt / ENSEMBLE_TIMED * 1e3,
                solo_captions_per_s=solo_rate, launches=launches)


def fleets(torch, aa, model, card, counters, recorder, solo_rate):
    """Phase 10: the multi-seed fleets and the ensemble at flagship width.
    The 2-member ensemble's kernel-vs-plain tokens; then, on a data set
    written to disk (phase 8's, plus flip features of the test images), the
    XE fleet (main --n_seeds 4, bf16, 100 images x 5, 11 steps, the boundary
    at 10), the SCST fleet warm-started from its best triples (main_rl
    --n_seeds 4, f32, 51 images x 5, 6 iterations, the boundary at 16), the
    ensemble CLI over the 4 rl_ best triples (beam 3, bf16, the 100 test
    images) without, with and again without --eval_flip_ensemble 1, and a
    4-member B = 512 ensemble's captions/s. Counters reset before and read
    after each run."""
    import shutil
    import tempfile

    from recurrent_fusion_network_torch import eval_ensemble as ensemble_cli
    from recurrent_fusion_network_torch import main as main_cli
    from recurrent_fusion_network_torch import main_rl as main_rl_cli

    t0 = time.perf_counter()
    out = {"ensemble_check": check_ensemble_tokens(torch, model, aa, counters)}
    torch.cuda.empty_cache()
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    mem_gb, free_gb = host_state()
    if free_gb < FLEET_FREE_GB:
        raise AssertionError(f"fleets: {free_gb:.1f} GB free under {build}, "
                             f"{FLEET_FREE_GB} GB needed")
    root = tempfile.mkdtemp(prefix="fleets_", dir=build)
    try:
        out.update(_fleets(torch, model, card, counters, recorder, root, main_cli,
                           main_rl_cli, ensemble_cli))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["throughput"] = ensemble_throughput(torch, model, counters, recorder, card, solo_rate)
    out["seconds"] = time.perf_counter() - t0
    log(f"fleets: phase 10 in {out['seconds']:.2f} s")
    return out


def _fleets(torch, model, card, counters, recorder, root, main_cli, main_rl_cli,
            ensemble_cli):
    from recurrent_fusion_network_torch.training.checkpoint import load_checkpoint

    S, per_eval = FLEET_SEEDS, 65 + 64
    t0 = time.perf_counter()
    data_argv, data_gb = write_driver_dataset(root, model, seed=1, flip_split="test")
    mem_gb, free_gb = host_state()
    log(f"fleets: data set of {data_gb:.2f} GB of features (with the test images' flip "
        f"features) written in {time.perf_counter() - t0:.2f} s; {free_gb:.1f} GB free on "
        f"disk, {mem_gb:.1f} GB of host memory available")
    ck = os.path.join(root, "checkpoint")
    results = os.path.join(root, "eval_results")
    common = data_argv + ["--device", DEVICE, "--checkpoint_path", ck, "--eval_results_dir",
                          results, "--val_images_use", "100", "--beam_size", "3",
                          "--language_eval", "1", "--seed", "0", "--losses_log_every", "5",
                          "--n_seeds", str(S), "--id", "fleet"]
    out, reckon = {}, state_gb(model)

    # XE fleet: steps 0..10, the boundary at 10, the epilogue eval at 11
    # on the same params (it writes nothing: no seed improves on itself)
    steps, log_xe = FLEET_XE_EVERY + 1, os.path.join(root, "fleet_xe.jsonl")
    res, xe = run_driver(
        torch, main_cli, common + ["--dtype", "bfloat16", "--batch_size", "100",
                                   "--seq_per_img", "5", "--save_checkpoint_every",
                                   str(FLEET_XE_EVERY), "--max_iterations", str(steps),
                                   "--json_log", log_xe],
        counters, (S * (65 * steps + 2 * per_eval), S * 65 * steps), "fleets XE", recorder,
        "fleet_xe")
    if sorted(os.listdir(ck)) != fleet_files("fleet", S) or res["iter"] != steps:
        raise AssertionError(f"fleets XE: files {sorted(os.listdir(ck))}, iter {res['iter']}")
    for r in range(S):
        _, saved = load_checkpoint(ck, "fleet", r, best=True)
        if saved["iter"] != steps or saved["opt"]["tied_att_keys"] != 1:
            raise AssertionError(f"fleets XE seed {r} best infos: iter {saved['iter']}")
    losses = [[h[i] for i in sorted(h)] for h in res["loss_histories"]]
    if not all(math.isfinite(x) for h in losses for x in h):
        raise AssertionError(f"fleets XE losses {losses}")
    del res
    stats = [check_stats(m, f"fleets XE seed {r} eval")
             for r, m in enumerate(jsonl(log_xe, "fleet_val")[0]["metrics"])]
    out["xe"] = fleet_summary(xe, log_xe, "fleet_train", S, "fleets XE bf16 B=100x5", card)
    out["xe"].update(losses=losses, stats=stats, state_gb_per_seed=reckon,
                     reckoned_peak_gb_s8=xe["peak_gb"] + 4 * reckon)
    mem_gb, free_gb = host_state()
    log(f"fleets XE: losses per seed {[[round(x, 3) for x in h] for h in losses]}; one seed's "
        f"f32 params and moments {reckon:.2f} GB, so S=8 would peak near "
        f"{out['xe']['reckoned_peak_gb_s8']:.2f} GB; {free_gb:.1f} GB free on disk, "
        f"{mem_gb:.1f} GB of host memory available")

    # SCST fleet from the XE best triples (iteration 11 on): iterations
    # 11..16, the boundary at 16 (two eval batches of 51 images), the
    # epilogue eval at 17 on the same params
    last = steps + FLEET_RL_ITERS
    log_rl = os.path.join(root, "fleet_rl.jsonl")
    res, rl = run_driver(
        torch, main_rl_cli,
        common + ["--batch_size", "51", "--seq_per_img", "5", "--dtype", "float32",
                  "--start_from", ck, "--load_model_id", "fleet",
                  "--save_checkpoint_every", str(last - 1), "--max_iterations", str(last),
                  "--json_log", log_rl, "--cider_df", os.path.join(root, "absent.p")],
        counters, (S * (130 * FLEET_RL_ITERS + 2 * 2 * per_eval), S * 65 * FLEET_RL_ITERS),
        "fleets SCST", recorder, "fleet_scst")
    rl_files = sorted(f for f in os.listdir(ck) if f.startswith("rl_"))
    # the mean rewards of this run's logged iterations (the history holds
    # the XE losses too)
    rewards = [[h[i] for i in sorted(h) if i >= steps] for h in res["loss_histories"]]
    if rl_files != fleet_files("fleet", S, "rl_") or res["iter"] != last \
            or not all(h and all(map(math.isfinite, h)) for h in rewards):
        raise AssertionError(f"fleets SCST: files {rl_files}, iter {res['iter']}, "
                             f"rewards {rewards}")
    out["scst"] = fleet_summary(rl, log_rl, "fleet_rl_train", S, "fleets SCST f32 B=51x5",
                                card)
    out["scst"].update(rewards=rewards, best_scores=res["cider_per_seed"],
                       stats=[check_stats(m, f"fleets SCST seed {r} eval") for r, m in
                              enumerate(jsonl(log_rl, "fleet_val")[0]["metrics"])])
    del res
    mem_gb, free_gb = host_state()
    log(f"fleets SCST: rewards per seed {[[round(x, 3) for x in h] for h in rewards]}, "
        f"best val scores {out['scst']['best_scores']}; {free_gb:.1f} GB free on disk, "
        f"{mem_gb:.1f} GB of host memory available")

    # the ensemble CLI over the 4 rl_ best triples, the 100 test images; the
    # plain run again after the flip run, as the first pays one-time costs
    argv = data_argv + ["--device", DEVICE, "--model_path", ck, "--model_ids", "fleet",
                        "--n_ranks", str(S), "--rl_prefix", "1", "--beam_size", "3",
                        "--dtype", "bfloat16", "--eval_split", "test", "--val_images_use",
                        "100", "--batch_size", "100", "--eval_results_dir", results]
    for run, flip in (("ensemble_eval", 0), ("ensemble_flip", 1), ("ensemble_eval_repeat", 0)):
        out[run] = run_ensemble_cli(torch, ensemble_cli,
                                    argv + ["--eval_flip_ensemble", str(flip)], counters,
                                    ((1 + flip) * S * 64, 0), f"fleets {run}", recorder, run)
        e = out[run]
        log(f"fleets {run} (beam 3, bf16, {S} members, 100 test images, flip {flip}): wall "
            f"{e['wall_s']:.2f} s with the checkpoint reads, eval {e['eval_s']:.2f} s, "
            f"{e['captions_per_s']:.1f} captions/s; metrics {e['stats']}; launches "
            f"{e['launches']} on {card}")
    return out



# ------------------------------------------------- 11. remat, optimizers, data front

# scripts/train_recurrent_fusion_model.sh's rates
FLAGSHIP_DROPOUT = dict(drop_prob_lm=0.3, drop_prob_reason=0.3, drop_prob_fusion=0.3)
REMAT_SS_PROB = 0.3
REMAT_STEPS = 12  # per variant: the first (grads checked) and the second not timed
REMAT_VARIANTS = (("off", False, "save_ctx", (65, 65)), ("off_again", False, "save_ctx", (65, 65)),
                  ("full", True, "full", (130, 65)), ("save_ctx", True, "save_ctx", (65, 65)))
OPTIMIZERS = {"rmsprop": dict(optim="rmsprop", optim_momentum=0.9),
              "adagrad": dict(optim="adagrad", optim_lr_decay=0.01),
              "adadelta": dict(optim="adadelta")}
OPTIM_STEPS = 3
FRONT_SHARD, FRONT_COMPARED = 64, 3  # shard rows; train batches compared and timed
FRONT_XE_EVERY, FRONT_RL_ITERS = 10, 6
FRONT_FREE_GB = 25  # 1.6 GB packed + 1.6 GB sharded, a 5.4 GB triple and an rl_ one
PHASE11_RUNS = ("remat_off", "remat_full", "remat_save_ctx", "optimizers", "front_xe",
                "front_scst")


def tree_max_diff(torch, a, b):
    """Largest |a - b| over two trees of CPU tensors of one layout."""
    from recurrent_fusion_network_torch.ops.initializers import tree_leaves

    return max((x - y).abs().max().item() for x, y in zip(tree_leaves(a), tree_leaves(b)))


def remat_phase(torch, aa, model, card):
    """Phase 11 (a): bf16 XE steps on phase 6's B = 512 batch with dropout
    at the flagship rates and ss_prob 0.3, without remat (twice: the run to
    run spread), under remat "full" and under "save_ctx", each from the
    same params and generator state: the first step's loss and grads
    against the first run's, exact launches per step, step ms (median of
    the last REMAT_STEPS - 2) and peak memory after the first step."""
    from dataclasses import replace

    from recurrent_fusion_network_torch.ops.initializers import tree_map
    from recurrent_fusion_network_torch.training.criterion import make_criterion
    from recurrent_fusion_network_torch.training.optim import make_optimizer
    from recurrent_fusion_network_torch.training.train_loop import (device_batch,
                                                                    make_train_step)

    opt = train_opts(model, dtype="bfloat16", **FLAGSHIP_DROPOUT)
    batch = device_batch(FixedBatchLoader(model, TRAIN_ROWS, 8).get_batch("train"), DEVICE,
                         torch.bfloat16)
    base = model.init_params(torch.Generator(device=DEVICE).manual_seed(11), device=DEVICE)
    start = torch.Generator(device=DEVICE).manual_seed(13).get_state()
    crit, held = make_criterion(opt), []

    def crit_marked(*a):  # called at the end of the forward: what the backward keeps
        held.append((torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()))
        return crit(*a)

    out, ref = {}, None
    for name, remat, policy, per_step in REMAT_VARIANTS:
        m = replace(model, use_remat=remat, remat_policy=policy, **FLAGSHIP_DROPOUT)
        spy = GradSpy(make_optimizer(opt))
        step = make_train_step(m, crit_marked, spy, torch.bfloat16)
        params = tree_map(torch.clone, base)
        state = spy.init(params)
        gen = torch.Generator(device=DEVICE)
        gen.set_state(start)
        steps = 1 if name == "off_again" else REMAT_STEPS
        losses, stamps, before = [], [], []
        held.clear()
        torch.cuda.synchronize()
        reset_counters([aa])
        peaks = []
        for k in range(steps):
            before.append(torch.cuda.memory_allocated())
            if k:
                peaks.append(torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
            params, state, loss = step(params, state, *batch, LR, REMAT_SS_PROB, gen)
            losses.append(loss.item())
            stamps.append(time.perf_counter())
            if k == 0:
                grads = tree_map(lambda t: t.cpu(), spy.grads)
                spy.grads, spy.update = None, spy.tx.update  # no more copies
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                stamps[0] = time.perf_counter()
        launches = read_counters([aa], f"remat {name}")
        if launches != (per_step[0] * steps, per_step[1] * steps):
            raise AssertionError(f"remat {name}: launches (fwd, bwd) {launches} over {steps} "
                                 f"steps, expected {per_step} per step")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"remat {name}: losses {losses}")
        row = dict(launches=launches, per_step=per_step, loss=losses[0], losses=losses)
        if ref is None:
            ref = (losses[0], grads)
            check_grads(torch, grads, f"remat {name} bf16 first step")
        else:
            row.update(loss_diff=abs(losses[0] - ref[0]), grad_max_diff=tree_max_diff(
                torch, ref[1], grads))
        if steps > 2:
            gaps = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
            row.update(step_ms=statistics.median(gaps), step_quartiles_ms=statistics.quantiles(
                gaps, n=4)[::2], steps_timed=len(gaps),
                peak_gb=max(peaks[1:] + [torch.cuda.max_memory_allocated()]) / 1e9,
                # allocated before the step (params, moments, the batch, the
                # master copy the variants start from), how much more at the
                # end of the forward (the activations the backward keeps),
                # and the forward's own peak
                start_gb=before[-1] / 1e9,
                forward_held_gb=statistics.median(h - b for (h, _), b in zip(held[1:],
                                                                             before[1:])) / 1e9,
                forward_peak_gb=max(p for _, p in held[1:]) / 1e9)
        out[name] = row
        del spy, step, params, state, grads
        torch.cuda.empty_cache()
    spread = (out["off_again"]["loss_diff"], out["off_again"]["grad_max_diff"])
    for name in ("full", "save_ctx"):
        r = out[name]
        log(f"remat {name}: first step's loss {r['loss']:.6f} (|diff| to off "
            f"{r['loss_diff']:.3e}), largest |grad diff| to off {r['grad_max_diff']:.3e} "
            f"(off run twice: {spread[0]:.3e} / {spread[1]:.3e}); step {r['step_ms']:.2f} ms "
            f"(median of {r['steps_timed']}, quartiles "
            f"{[round(q, 2) for q in r['step_quartiles_ms']]}) against off "
            f"{out['off']['step_ms']:.2f} ms; held at the end of the forward "
            f"{r['forward_held_gb']:.3f} GB against off {out['off']['forward_held_gb']:.3f} GB, "
            f"peak of the forward {r['forward_peak_gb']:.2f} GB against off "
            f"{out['off']['forward_peak_gb']:.2f} GB, of the step {r['peak_gb']:.2f} GB "
            f"against off {out['off']['peak_gb']:.2f} GB (allocated before a step "
            f"{r['start_gb']:.2f} GB); launches per step {r['per_step']} on {card}")
        if r["loss_diff"] > spread[0] or r["grad_max_diff"] > spread[1]:
            raise AssertionError(f"remat {name} differs from no remat beyond the spread of two "
                                 f"runs without it: {r['loss_diff']}, {r['grad_max_diff']}")
    del base, batch
    torch.cuda.empty_cache()
    return out


def optimizer_phase(torch, aa, model, card):
    """Phase 11 (b): OPTIM_STEPS bf16 XE steps of each of rmsprop (momentum
    0.9), adagrad (lr_decay 0.01) and adadelta on phase 6's batch: loss,
    params and every state leaf finite; launches; step ms and peak memory."""
    from recurrent_fusion_network_torch.ops.initializers import tree_leaves
    from recurrent_fusion_network_torch.training.criterion import make_criterion
    from recurrent_fusion_network_torch.training.optim import make_optimizer
    from recurrent_fusion_network_torch.training.train_loop import (device_batch,
                                                                    make_train_step)

    batch = device_batch(FixedBatchLoader(model, TRAIN_ROWS, 8).get_batch("train"), DEVICE,
                         torch.bfloat16)
    out, total = {}, (0, 0)
    for name, over in OPTIMIZERS.items():
        opt = train_opts(model, dtype="bfloat16", **over)
        tx = make_optimizer(opt)
        step = make_train_step(model, make_criterion(opt), tx, torch.bfloat16)
        params = model.init_params(torch.Generator(device=DEVICE).manual_seed(17),
                                   device=DEVICE)
        state = tx.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters([aa])
        losses, stamps = [], [time.perf_counter()]
        for _ in range(OPTIM_STEPS):
            params, state, loss = step(params, state, *batch, LR, 0.0, None)
            losses.append(loss.item())
            stamps.append(time.perf_counter())
        launches = read_counters([aa], f"optimizer {name}")
        total = (total[0] + launches[0], total[1] + launches[1])
        leaves = [t for f in state if not isinstance(f, int) for t in tree_leaves(f)]
        finite = (all(map(math.isfinite, losses))
                  and all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))
                  and all(bool(torch.isfinite(t).all()) for t in leaves))
        state_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
        gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        out[name] = dict(losses=losses, launches=launches, step_ms=gaps,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9, state_gb=state_gb,
                         state_entries=sum(t.numel() for t in leaves))
        log(f"optimizer {name} bf16 B={TRAIN_ROWS}: losses {[round(x, 4) for x in losses]}, "
            f"params and {len(leaves)} state leaves finite: {finite}; state "
            f"{out[name]['state_entries']:,} f32 entries ({state_gb:.2f} GB); steps "
            f"{[round(g, 2) for g in gaps]} ms; peak {out[name]['peak_gb']:.2f} GB; launches "
            f"{launches} on {card}")
        if not finite or launches != (65 * OPTIM_STEPS, 65 * OPTIM_STEPS):
            raise AssertionError(f"optimizer {name}: finite {finite}, launches {launches}")
        del step, params, state, leaves
        torch.cuda.empty_cache()
    out["launches"] = total
    return out


def write_karpathy(path, model, seed=0):
    """A Karpathy-format dataset JSON of 300 / 100 / 100 train / val / test
    images with 5 captions each of 8-20 tokens (some longer than the 16 the
    labels keep), every one of phase 8's 9,487 words at least twice: so
    prepro_labels --word_count_threshold 1 keeps them all and no UNK.
    -> (image ids, the words)."""
    import numpy as np

    g = np.random.default_rng(seed)
    words = CAPTION_WORDS + [f"w{i}" for i in range(len(CAPTION_WORDS), DRIVER_VOCAB)]
    n_img = sum(DRIVER_IMAGES.values())
    lengths = g.integers(8, 21, n_img * DRIVER_CAPS)
    pool = np.array(words * 2 + list(g.choice(CAPTION_WORDS, int(lengths.sum())
                                               - 2 * len(words))))
    if len(pool) != lengths.sum():
        raise AssertionError("write_karpathy: too few caption tokens for the vocabulary")
    g.shuffle(pool)
    cuts = np.cumsum(lengths)[:-1]
    caps = [list(c) for c in np.split(pool, cuts)]
    images, ids = [], []
    for split, n in DRIVER_IMAGES.items():
        for _ in range(n):
            ids.append(100_000 + len(ids))
            sents = [{"tokens": caps[k], "raw": " ".join(caps[k])}
                     for k in range((len(ids) - 1) * DRIVER_CAPS, len(ids) * DRIVER_CAPS)]
            images.append({"split": split, "filepath": f"{split}2014",
                           "filename": f"{ids[-1]}.jpg", "cocoid": ids[-1],
                           "sentences": sents})
    with open(path, "w") as f:
        json.dump({"images": images, "dataset": "coco"}, f)
    return ids, words


def same_batch(a, b):
    """Two loader batch dicts equal key by key, arrays byte for byte."""
    import numpy as np

    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            if len(x) != len(y) or not all(u.dtype == v.dtype and u.shape == v.shape
                                           and u.tobytes() == v.tobytes()
                                           for u, v in zip(x, y)):
                return False
        elif isinstance(x, np.ndarray):
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                return False
        elif x != y:
            return False
    return True


def data_front(torch, model, card, counters, recorder):
    """Phase 11 (c): the runbook's path from a caption corpus, through the
    CLIs: Karpathy JSON -> prepro_labels -> prepro_ngrams --karpathy_json
    -> sharded stores -> main (--use_remat 1 --remat_policy save_ctx --optim
    rmsprop) -> main_rl --cider_df, on files written under build/ and
    deleted when done."""
    import shutil
    import tempfile

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    free_gb = shutil.disk_usage(build).free / 1e9
    if free_gb < FRONT_FREE_GB:
        raise AssertionError(f"data front: {free_gb:.1f} GB free under {build}, "
                             f"{FRONT_FREE_GB} GB needed")
    root = tempfile.mkdtemp(prefix="front_", dir=build)
    try:
        return _data_front(torch, model, card, counters, recorder, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _data_front(torch, model, card, counters, recorder, root):
    import pickle

    import numpy as np

    from recurrent_fusion_network_torch import feat_registry
    from recurrent_fusion_network_torch import main as main_cli
    from recurrent_fusion_network_torch import main_rl as main_rl_cli
    from recurrent_fusion_network_torch.config import parse_opt
    from recurrent_fusion_network_torch.data import prepro_labels, prepro_ngrams
    from recurrent_fusion_network_torch.data.build import build_loader
    from recurrent_fusion_network_torch.data.dataset import Dataset, PackedFeatureSource
    from recurrent_fusion_network_torch.data.loader import DataLoader
    from recurrent_fusion_network_torch.data.sharded import pack_to_shards

    out = {}
    t0 = time.perf_counter()
    karpathy = os.path.join(root, "dataset_coco.json")
    ids, words = write_karpathy(karpathy, model)
    paths = {k: os.path.join(root, f) for k, f in (
        ("input_json", "cocotalk.json"), ("input_label_h5", "cocotalk_label.npz"),
        ("top_words_path", "vocab_train.pkl"), ("cider_df", "coco-train-idxs.p"))}
    t1 = time.perf_counter()
    prepro_labels.main(["--input_json", karpathy, "--output_json", paths["input_json"],
                        "--output_labels", paths["input_label_h5"], "--output_top_words",
                        paths["top_words_path"], "--word_count_threshold", "1"])
    t2 = time.perf_counter()
    prepro_ngrams.main(["--input_json", paths["input_json"], "--input_labels",
                        paths["input_label_h5"], "--karpathy_json", karpathy, "--output_pkl",
                        paths["cider_df"]])
    t3 = time.perf_counter()
    with open(paths["input_json"]) as f:
        vocab = json.load(f)["ix_to_word"]
    with open(paths["cider_df"], "rb") as f:
        df = pickle.load(f)
    if len(vocab) != DRIVER_VOCAB or set(vocab.values()) != set(words):
        raise AssertionError(f"data front: prepro_labels gave {len(vocab)} words, not phase "
                             f"8's {DRIVER_VOCAB}")
    out.update(prepro_labels_s=t2 - t1, prepro_ngrams_s=t3 - t2, vocab=len(vocab),
               df_ngrams=len(df["document_frequency"]), ref_len=df["ref_len"])
    log(f"data front: Karpathy JSON of {len(ids)} images x {DRIVER_CAPS} captions written in "
        f"{t1 - t0:.2f} s; prepro_labels {t2 - t1:.2f} s ({len(vocab)} words, no UNK); "
        f"prepro_ngrams --karpathy_json {t3 - t2:.2f} s ({len(df['document_frequency']):,} "
        f"n-grams, ref_len {df['ref_len']:.4f})")

    data_root = os.path.join(root, "features")
    t0 = time.perf_counter()
    n_bytes = write_packed_features(data_root, ids, np.random.default_rng(0))
    t1 = time.perf_counter()
    shards = []
    for info in feat_registry.feat_array_info(data_root):
        src = pack_to_shards(os.path.join(data_root, info.name, "packed"),
                             os.path.join(data_root, info.name, "sharded"),
                             shard_size=FRONT_SHARD)
        shards.append(len(src.shards))
    t2 = time.perf_counter()
    out.update(features_gb=n_bytes / 1e9, packed_write_s=t1 - t0, pack_to_shards_s=t2 - t1,
               shards=shards)
    log(f"data front: {n_bytes / 1e9:.2f} GB of packed features written in {t1 - t0:.2f} s, "
        f"packed into sharded stores of {FRONT_SHARD} rows ({shards} shards) in "
        f"{t2 - t1:.2f} s")

    # the loader on the sharded stores (as the CLIs build it) against one on
    # the packed stores beside them: the same batches, byte for byte
    data_argv = ["--caption_model", "recurrent_fusion_model", "--feature_type", "feat_array",
                 "--data_root", data_root] + [a for k in ("input_json", "input_label_h5",
                                                         "top_words_path")
                                              for a in (f"--{k}", paths[k])]
    opt = parse_opt(data_argv + ["--device", DEVICE, "--batch_size", "100", "--seq_per_img",
                                 "5", "--seed", "0"])
    sharded = build_loader(opt, prefetch=False)
    packed = DataLoader(opt, Dataset.from_files(opt.input_json, opt.input_label_h5,
                                                opt.top_words_path, opt.top_words_count),
                        [PackedFeatureSource(os.path.join(data_root, f["name"], "packed"))
                         for f in opt.feat_array_info], prefetch=False)
    fetch = {"sharded": [], "packed": []}
    try:
        if [s.engine for s in sharded.sources] != ["native"] * 5:
            raise AssertionError(f"data front: sources {[type(s).__name__ for s in sharded.sources]} "
                                 f"engines {[getattr(s, 'engine', None) for s in sharded.sources]}")
        for k in range(FRONT_COMPARED):
            batches = {}
            for name in (("sharded", "packed") if k % 2 == 0 else ("packed", "sharded")):
                t0 = time.perf_counter()
                batches[name] = (sharded if name == "sharded" else packed).get_batch("train")
                fetch[name].append((time.perf_counter() - t0) * 1e3)
            if not same_batch(batches["sharded"], batches["packed"]):
                raise AssertionError(f"data front: train batch {k} differs between the sharded "
                                     f"and the packed stores")
            del batches
        gathers = [s.native_gathers for s in sharded.sources]
        opened = [s.shards_opened for s in sharded.sources]
    finally:
        sharded.close()
        packed.close()
    if min(gathers) < FRONT_COMPARED:
        raise AssertionError(f"data front: native gathers {gathers}")
    out.update(fetch_ms=fetch, native_gathers=gathers, shards_opened=opened)
    log(f"data front: {FRONT_COMPARED} train batches of 100 x 5 equal byte for byte from the "
        f"sharded and the packed stores; loader fetch ms sharded "
        f"{[round(x, 2) for x in fetch['sharded']]}, packed "
        f"{[round(x, 2) for x in fetch['packed']]} (order alternated); native gathers per "
        f"encoder {gathers}, shards opened {opened} on {card}")

    ck = os.path.join(root, "checkpoint")
    common = data_argv + ["--device", DEVICE, "--checkpoint_path", ck, "--eval_results_dir",
                          os.path.join(root, "eval_results"), "--val_images_use", "100",
                          "--beam_size", "3", "--language_eval", "1", "--seed", "0",
                          "--losses_log_every", "5", "--use_remat", "1", "--remat_policy",
                          "save_ctx", "--optim", "rmsprop"]
    per_eval, steps = 65 + 64, FRONT_XE_EVERY + 1
    log_xe = os.path.join(root, "xe.jsonl")
    infos, xe = run_driver(
        torch, main_cli, common + ["--dtype", "bfloat16", "--batch_size", "100",
                                   "--seq_per_img", "5", "--save_checkpoint_every",
                                   str(FRONT_XE_EVERY), "--max_iterations", str(steps),
                                   "--id", "front", "--json_log", log_xe],
        counters, (65 * steps + per_eval, 65 * steps), "data front XE", recorder, "front_xe")
    [val] = jsonl(log_xe, "val")
    losses = [infos["loss_history"][i] for i in sorted(infos["loss_history"])]
    state = type(infos["final_opt_state"]).__name__
    if state != "RmspropState" or not all(map(math.isfinite, losses)) \
            or xe["sources"] != [("ShardedFeatureSource", "native")] * 5:
        raise AssertionError(f"data front XE: state {state}, losses {losses}, sources "
                             f"{xe['sources']}")
    del infos
    xe.update(stats=check_stats(val, "data front XE eval"), losses=losses,
              eval_s=val["seconds"], triples_write_s=val["save_seconds"])
    log(f"data front XE bf16 B=100x5 (remat save_ctx, rmsprop): steady step "
        f"{xe['step_ms']:.2f} ms, quartiles {[round(q, 2) for q in xe['step_quartiles_ms']]} "
        f"({xe['steady_gaps']} gaps); loader wait {xe['loader_wait_ms']:.2f} ms per fetch; "
        f"losses {[round(x, 3) for x in losses]}; boundary eval {xe['eval_s']:.2f} s, triples "
        f"{xe['triples_write_s']:.2f} s; metrics {xe['stats']}; launches {xe['launches']}; "
        f"peak {xe['peak_gb']:.2f} GB on {card}")
    out["xe"] = xe

    last = steps + FRONT_RL_ITERS
    log_rl = os.path.join(root, "rl.jsonl")
    infos, rl = run_driver(
        torch, main_rl_cli,
        common + ["--batch_size", "51", "--seq_per_img", "5", "--dtype", "float32",
                  "--start_from", ck, "--load_model_id", "front", "--id", "front",
                  "--load_lr", "1", "--save_checkpoint_every", str(last - 1),
                  "--max_iterations", str(last), "--json_log", log_rl,
                  "--cider_df", paths["cider_df"]],
        counters, (130 * FRONT_RL_ITERS + 2 * per_eval, 65 * FRONT_RL_ITERS),
        "data front SCST", recorder, "front_scst")
    [val] = jsonl(log_rl, "rl_val")
    rewards = [e["avg_reward"] for e in jsonl(log_rl, "rl_train")]
    state = type(infos["final_opt_state"]).__name__
    if infos["iter"] != last or state != "RmspropState" or not rewards \
            or not all(map(math.isfinite, rewards)):
        raise AssertionError(f"data front SCST: iter {infos['iter']}, state {state}, rewards "
                             f"{rewards}")
    del infos
    rl.update(stats=check_stats(val, "data front SCST eval"), rewards=rewards,
              eval_s=val["seconds"])
    log(f"data front SCST f32 B=51x5 from the XE best triple (--load_lr 1, --cider_df of "
        f"prepro_ngrams): steady iteration {rl['step_ms']:.2f} ms, quartiles "
        f"{[round(q, 2) for q in rl['step_quartiles_ms']]}; rewards "
        f"{[round(x, 4) for x in rewards]}; metrics {rl['stats']}; launches {rl['launches']}; "
        f"peak {rl['peak_gb']:.2f} GB on {card}")
    out["scst"] = rl
    return out


def phase11(torch, aa, model, card, recorder):
    """Phase 11: remat, the three optimizers, the data front."""
    t0 = time.perf_counter()
    out = {"remat": remat_phase(torch, aa, model, card)}
    out["optimizers"] = optimizer_phase(torch, aa, model, card)
    out["front"] = data_front(torch, model, card, [aa], recorder)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 11 in {out['seconds']:.2f} s")
    return out


# ------------------------------------------------------------ 12. raw images

BACKBONES = (("resnet101", 448, 14), ("densenet161", 224, 7), ("inception_v3", 299, 8),
             ("inception_v4", 299, 8), ("inception_resnet_v2", 299, 8))
TF32_OPS_PER_S = 495e12  # H100 SXM, dense TF32
BACKBONE_CHECK_ROWS, BACKBONE_ROWS, BACKBONE_REPS = 2, 16, 5
# card (TF32 off) vs CPU, both f32: max |card - CPU| / max |CPU| of fc and of
# att, sums of up to 4,608 products in another order through 100-470 convs
BACKBONE_TOL = 1e-3
RAW_IMAGES, RAW_NATIVE = 64, 32  # seeded JPEGs; the first RAW_NATIVE at 448 x 448
RAW_BATCH, RAW_REQUESTS = 16, 32
RAW_FREE_GB = 5  # 1.0 GB a packed store of the 10 variants, three of them at most
RAW_RESIDUAL_SCALE = 0.2  # bn3 weights of the seeded resnet101 (bounded activations)
RAW_SIGTERM_AT = 40  # the image whose decode brings the SIGTERM (in the third chunk)


def conv_macs(torch, raw, shapes, image_size):
    """Multiply-adds of one image through a backbone, counted from the
    shapes of its convolutions (a forward on the meta device)."""
    from unittest import mock

    import torch.nn.functional as F

    real, macs = F.conv2d, [0]

    def counting(x, w, *a, **kw):
        out = real(x, w, *a, **kw)
        macs[0] += out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return out

    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    with mock.patch.object(F, "conv2d", counting):
        raw(meta, torch.empty(1, image_size, image_size, 3, device="meta"))
    return macs[0]


def rel_err(a, b):
    return ((a.float().cpu() - b.float().cpu()).abs().max() / b.float().abs().max()).item()


def backbone_phase(torch, card):
    """Phase 12 (a): the five runbook encoders at their native geometry,
    random weights from a seeded generator: fc and att on the card (TF32
    off) against the same backbone on the CPU at B = 2; ms per B = 16
    batch with TF32 off (the extraction path's setting) and on, images/s,
    the peak GB above the weights, the host's ms to queue one forward; the
    bound 2 x MACs / peak rate (f32 67 TFLOP/s, TF32 495)."""
    from recurrent_fusion_network_torch.data.feature_extraction import backbones

    rows = []
    for arch, size, grid in BACKBONES:
        raw, shapes, fc_dim, att_dim = backbones.trunk(arch, grid)
        params, feats, _, _ = backbones.build_backbone(arch, grid, device="cpu")
        x = torch.rand(BACKBONE_CHECK_ROWS, size, size, 3,
                       generator=torch.Generator().manual_seed(30))
        t0 = time.perf_counter()
        fc_cpu, att_cpu = feats(params, x)
        cpu_s = time.perf_counter() - t0
        params = {k: v.to(DEVICE) for k, v in params.items()}
        xd = x.to(DEVICE)
        with torch.inference_mode():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                fc_off, att_off = raw(params, xd)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                fc_on, att_on = raw(params, xd)
        err = max(rel_err(fc_off, fc_cpu), rel_err(att_off, att_cpu))
        tf32_diff = max(rel_err(fc_on, fc_off), rel_err(att_on, att_off))
        if fc_off.shape != (BACKBONE_CHECK_ROWS, fc_dim) or \
                att_off.shape != (BACKBONE_CHECK_ROWS, grid, grid, att_dim):
            raise AssertionError(f"{arch}: fc {tuple(fc_off.shape)}, att {tuple(att_off.shape)}")
        if not (err <= BACKBONE_TOL and torch.isfinite(fc_off).all() and
                torch.isfinite(att_off).all()):
            raise AssertionError(f"{arch}: card vs CPU max rel err {err:.3e} > {BACKBONE_TOL}")
        xb = torch.rand(BACKBONE_ROWS, size, size, 3, device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(31))
        times = {}
        for tf32 in (False, True):
            def call():
                with torch.inference_mode(), \
                        torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                    raw(params, xb)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = event_ms(torch, call, [()], reps=BACKBONE_REPS, repeats=3)
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            host = []  # the host's time to queue one forward, the card still busy
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                host.append((time.perf_counter() - t0) * 1e3)
            times[tf32] = (ms, peak, statistics.median(host))
        macs = conv_macs(torch, raw, shapes, size)
        flops = 2 * macs * BACKBONE_ROWS
        row = dict(arch=arch, image_size=size, grid=grid, fc_dim=fc_dim, att_dim=att_dim,
                   params=sum(v.numel() for v in params.values()),
                   max_rel_err_vs_cpu=err, tf32_max_rel_diff=tf32_diff, cpu_s=cpu_s,
                   macs_per_image=macs, ms=times[False][0], ms_tf32=times[True][0],
                   host_ms=times[False][2], host_ms_tf32=times[True][2],
                   images_per_s=BACKBONE_ROWS / times[False][0] * 1e3,
                   images_per_s_tf32=BACKBONE_ROWS / times[True][0] * 1e3,
                   params_gb=sum(v.numel() for v in params.values()) * 4 / 1e9,
                   peak_gb=times[False][1], peak_gb_tf32=times[True][1],
                   bound_ms=flops / F32_OPS_PER_S * 1e3,
                   bound_ms_tf32=flops / TF32_OPS_PER_S * 1e3)
        log(f"raw images backbone {arch} {size} px -> {grid}x{grid}: fc {fc_dim}, att "
            f"{att_dim}, {row['params']} params; card (TF32 off) vs CPU max rel err {err:.3e} "
            f"(tol {BACKBONE_TOL}), TF32 on vs off {tf32_diff:.3e}; B={BACKBONE_ROWS} "
            f"forward {row['ms']:.2f} ms ({row['images_per_s']:.1f} images/s, "
            f"{row['peak_gb']:.2f} GB peak above the {row['params_gb']:.2f} GB of weights; "
            f"the host queues it in {row['host_ms']:.2f} ms), TF32 {row['ms_tf32']:.2f} ms "
            f"({row['images_per_s_tf32']:.1f} images/s, {row['peak_gb_tf32']:.2f} GB; host "
            f"{row['host_ms_tf32']:.2f} ms); "
            f"{macs / 1e9:.3f} GMAC per image, bound {row['bound_ms']:.2f} ms f32 / "
            f"{row['bound_ms_tf32']:.2f} ms TF32 (bound/ms {row['bound_ms'] / row['ms']:.3f} / "
            f"{row['bound_ms_tf32'] / row['ms_tf32']:.3f}) on {card}")
        rows.append(row)
        del params, xd, xb, fc_off, att_off, fc_on, att_on
        torch.cuda.empty_cache()
    return rows


def write_raw_images(root):
    """RAW_IMAGES seeded JPEGs with COCO names: the first RAW_NATIVE at
    448 x 448 (both resizes leave them as they are), the rest of mixed sizes
    from 200 to 640 px; smooth content (seeded noise upsampled)."""
    import numpy as np
    from PIL import Image

    g = np.random.default_rng(40)
    sizes = [(448, 448)] * RAW_NATIVE + [(int(g.integers(200, 641)), int(g.integers(200, 641)))
                                         for _ in range(RAW_IMAGES - RAW_NATIVE)]
    names = []
    for i, (h, w) in enumerate(sizes):
        small = (g.random((h // 16 + 2, w // 16 + 2, 3)) * 255).astype(np.uint8)
        name = f"COCO_val2014_{100000 + i:012d}.jpg"
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(os.path.join(root, name),
                                                                   quality=90)
        names.append(name)
    return names


def write_resnet101_weights(torch, path):
    """A seeded resnet101 state dict in torchvision's layout (its 1000-way
    classifier too), each residual branch's last BN scaled by
    RAW_RESIDUAL_SCALE so that activations stay bounded."""
    from recurrent_fusion_network_torch.data.feature_extraction import resnet

    g = torch.Generator().manual_seed(41)
    sd = resnet.resnet_init(g, resnet.ResNetConfig.resnet101())
    sd = {k: v * RAW_RESIDUAL_SCALE if k.endswith("bn3.weight") else v for k, v in sd.items()}
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)


def extract_phase(torch, card, root, images, weights):
    """Phase 12 (b): the extract CLI, resnet101 with --variants all, packed,
    then sharded; rows against an in-process forward of the same images; a
    SIGTERM mid-run and a resume to the same bytes; images/s and the
    host's decode / resize share."""
    from unittest import mock

    import numpy as np

    from recurrent_fusion_network_torch.data.dataset import PackedFeatureSource
    from recurrent_fusion_network_torch.data.feature_extraction import extract
    from recurrent_fusion_network_torch.data.feature_extraction.augment import make_variant
    from recurrent_fusion_network_torch.data.feature_extraction.backbones import build_backbone
    from recurrent_fusion_network_torch.data.sharded import ShardedFeatureSource
    from recurrent_fusion_network_torch.feat_registry import VARIANTS

    names = sorted(os.listdir(images))
    ids = [extract.image_id_from_name(n) for n in names]
    real_load = extract.load_image
    decode_s = []

    def timed_load(path, size):
        t0 = time.perf_counter()
        try:
            return real_load(path, size)
        finally:
            decode_s.append(time.perf_counter() - t0)

    def run(out, *extra, load=timed_load):
        argv = ["--images_dir", images, "--output_dir", out, "--arch", "resnet101",
                "--variants", "all", "--torch_weights", weights, "--batch_size",
                str(RAW_BATCH), *extra]
        decode_s.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(extract, "load_image", load), \
                contextlib.redirect_stdout(io.StringIO()) as printed:
            extract.main(argv)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sum(decode_s), printed.getvalue()

    packed = os.path.join(root, "packed")
    wall, dec, _ = run(packed)
    out = dict(images=RAW_IMAGES, variants=len(VARIANTS), wall_s=wall, decode_s=dec,
               decode_share=dec / wall, images_per_s=RAW_IMAGES / wall,
               image_variants_per_s=RAW_IMAGES * len(VARIANTS) / wall)
    src = PackedFeatureSource(packed)
    if json.load(open(os.path.join(packed, "ids.json"))) != ids:
        raise AssertionError("extract: ids.json is not the images' ids")

    # rows against an in-process forward of the same images, chunk by chunk
    params, feats, _, _ = build_backbone("resnet101", 14, weights)
    worst, bitwise = 0.0, True
    for start in range(0, RAW_IMAGES, RAW_BATCH):
        imgs = extract.load_batch(images, names[start:start + RAW_BATCH], 448,
                                  torch.device(DEVICE))
        for variant in VARIANTS:
            fc, att = feats(params, make_variant(imgs, variant))
            want_fc, want_att = fc.cpu().numpy(), att.reshape(len(imgs), 196, 2048).cpu().numpy()
            for i, image_id in enumerate(ids[start:start + RAW_BATCH]):
                got_fc, got_att = src.load(image_id, variant)
                bitwise &= np.array_equal(got_fc, want_fc[i]) and np.array_equal(got_att,
                                                                                  want_att[i])
                worst = max(worst, float(np.abs(got_fc - want_fc[i]).max()
                                         / np.abs(want_fc[i]).max()),
                            float(np.abs(got_att - want_att[i]).max()
                                  / np.abs(want_att[i]).max()))
    del params, src
    torch.cuda.empty_cache()
    if worst > 1e-5:
        raise AssertionError(f"extract: rows differ from the in-process forward by {worst:.3e}")
    out.update(rows_max_rel_err=worst, rows_bitwise=bitwise)

    sharded = os.path.join(root, "sharded")
    out["sharded_wall_s"] = run(sharded, "--output_format", "sharded", "--shard_size",
                                str(RAW_BATCH))[0]
    ps, ss = PackedFeatureSource(packed), ShardedFeatureSource(sharded)
    sharded_equal = all(np.array_equal(a, b) for image_id in ids for v in VARIANTS
                        for a, b in zip(ps.load(image_id, v), ss.load(image_id, v)))
    if not sharded_equal:
        raise AssertionError("extract: the sharded store's rows differ from the packed store's")
    del ps, ss

    # SIGTERM while the third chunk decodes, then the same command again
    resumed = os.path.join(root, "resumed")

    def sigterm_load(path, size):
        if os.path.basename(path) == names[RAW_SIGTERM_AT]:
            os.kill(os.getpid(), signal.SIGTERM)
        return timed_load(path, size)

    _, _, printed = run(resumed, load=sigterm_load)
    marker = json.load(open(os.path.join(resumed, "progress.json")))["done"]
    stopped_at = (RAW_SIGTERM_AT // RAW_BATCH + 1) * RAW_BATCH
    if marker != stopped_at or os.path.exists(os.path.join(resumed, "ids.json")) \
            or "preempted" not in printed:
        raise AssertionError(f"extract: after SIGTERM the marker reads {marker}, not "
                             f"{stopped_at}, or ids.json exists")
    _, _, printed = run(resumed)
    if f"resuming extraction at row {stopped_at}" not in printed:
        raise AssertionError(f"extract: the second run did not resume: {printed[:200]}")
    same = sorted(f for f in os.listdir(packed) if f != "progress.json")
    for f in same:
        with open(os.path.join(packed, f), "rb") as a, open(os.path.join(resumed, f), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"extract: {f} after the resume differs from the "
                                     f"uninterrupted run's")
    for d in (packed, sharded, resumed):
        shutil.rmtree(d)
    out.update(sigterm_marker=marker, resumed_files_equal=len(same))
    log(f"raw images extract: resnet101 448 px, {RAW_IMAGES} JPEGs x {len(VARIANTS)} variants "
        f"packed in {wall:.2f} s ({out['images_per_s']:.1f} images/s, "
        f"{out['image_variants_per_s']:.1f} image-variants/s; host decode + resize "
        f"{dec:.2f} s, {out['decode_share']:.3f} of the run), sharded in "
        f"{out['sharded_wall_s']:.2f} s; rows vs the in-process forward max rel err "
        f"{worst:.3e} (bitwise {bitwise}); sharded = packed; SIGTERM at image "
        f"{RAW_SIGTERM_AT} -> marker {marker}, resumed to the same bytes ({len(same)} files) "
        f"on {card}")
    return out


def raw_image_models(torch, root):
    """Checkpoint triples at published widths on the registry's resnet
    features (fc 2048, att 196 x 2048), random weights from a seeded
    generator: ShowTell (E = R = 512, 1 layer) and ReviewNet (H = 512, 8
    review steps, 1000 top words, tied keys), vocab 9487, 16 tokens. ->
    {run id: launches of additive_attention_fwd per beam-3 batch}."""
    from recurrent_fusion_network_torch.config import parse_opt
    from recurrent_fusion_network_torch.convert import params_to_jax
    from recurrent_fusion_network_torch.models import setup
    from recurrent_fusion_network_torch.training.checkpoint import save_checkpoint
    from recurrent_fusion_network_torch.training.train_loop import snapshot_opt

    vocab = {str(i): f"w{i}" for i in range(1, 9488)}
    common = ["--feature_type", "resnet", "--rnn_size", str(HID), "--input_encoding_size",
              str(HID)]
    per_batch = {}
    for run_id, argv in (("show_tell_resnet", ["--caption_model", "show_tell",
                                               "--num_layers", "1"]),
                         ("review_net_resnet", ["--caption_model", "review_net",
                                                "--att_hid_size", str(HID),
                                                "--num_review_steps", "8",
                                                "--top_words_count", "1000"])):
        opt = parse_opt(common + argv)
        opt.vocab_size, opt.seq_length = len(vocab), 16
        model = setup(opt)
        params = model.init_params(torch.Generator(device=DEVICE).manual_seed(50), device=DEVICE)
        save_checkpoint(root, run_id, 0, params=params_to_jax(params),
                        infos={"opt": snapshot_opt(opt), "vocab": vocab}, best=True)
        per_batch[run_id] = model_launches(model)[0]
        del params
    return per_batch


def raw_image_sites(batch):
    """Forward sites of ReviewNet on the resnet grid per beam-3 batch of
    ``batch`` images: the 8 review steps over 196 x 2048, the 16 beam
    steps over the 8 thought vectors at batch x 3 rows."""
    return [("review_net_resnet_review", 1, batch, 196, 2048,
             {"image_folder": 8, "caption_image": 8}),
            ("review_net_resnet_decoder_beam", 1, batch * BEAM, 8, HID,
             {"image_folder": 16, "caption_image": 16})]


def eval_folder_phase(torch, card, counters, recorder, root, images, weights, per_batch):
    """Phase 12 (c): eval --image_folder on the JPEGs with the seeded
    resnet101 weights, per triple: images/s and the forward kernel's
    launches (24 per beam-3 batch for ReviewNet, none for ShowTell)."""
    from recurrent_fusion_network_torch import eval as eval_cli

    out = {}
    n_batches = -(-RAW_IMAGES // RAW_BATCH)
    for run_id, launches_per_batch in per_batch.items():
        argv = ["--model_path", root, "--load_model_id", run_id, "--image_folder", images,
                "--beam_size", str(BEAM), "--batch_size", str(RAW_BATCH), "--backbone_weights",
                weights]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(counters)
        t0 = time.perf_counter()
        with recorder.run(f"image_folder_{run_id}"), \
                contextlib.redirect_stdout(io.StringIO()) as printed:
            preds = eval_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters(counters, f"eval --image_folder {run_id}")
        expect = (launches_per_batch * n_batches, 0)
        if launches != expect or recorder.totals(f"image_folder_{run_id}") != expect:
            raise AssertionError(f"eval --image_folder {run_id}: launches {launches}, expected "
                                 f"{expect}")
        lines = printed.getvalue().splitlines()
        if len(preds) != RAW_IMAGES or sorted(p["file"] for p in preds) != sorted(
                os.listdir(images)) or not all(f"{p['file']}\t{p['caption']}" in lines
                                               for p in preds):
            raise AssertionError(f"eval --image_folder {run_id}: {len(preds)} captions")
        out[run_id] = dict(wall_s=wall, images_per_s=RAW_IMAGES / wall, launches=launches,
                           distinct_captions=len({p["caption"] for p in preds}),
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                           captions={p["file"]: p["caption"] for p in preds})
        log(f"raw images eval --image_folder {run_id}: {RAW_IMAGES} images in {wall:.2f} s "
            f"({RAW_IMAGES / wall:.1f} images/s, the CLI's whole run), "
            f"{out[run_id]['distinct_captions']} distinct captions, e.g. "
            f"{preds[0]['caption']!r}; launches {launches} ({launches_per_batch} per beam-3 "
            f"batch); peak {out[run_id]['peak_gb']:.2f} GB on {card}")
    return out


def caption_image_phase(torch, card, counters, recorder, root, images, weights, per_batch,
                        want):
    """Phase 12 (d): serve --backbone_weights over the ReviewNet triple:
    RAW_REQUESTS concurrent POST /caption_image of the 448 x 448 JPEGs; their
    captions against eval --image_folder's for the same files, latency p50
    / p95, and launches 24 per decoded batch."""
    import http.client

    from recurrent_fusion_network_torch.config import parse_serve_opt
    from recurrent_fusion_network_torch.decoding.http_serve import run_server
    from recurrent_fusion_network_torch.serve import build_service

    files = sorted(os.listdir(images))[:RAW_REQUESTS]
    bodies = [open(os.path.join(images, f), "rb").read() for f in files]
    with contextlib.redirect_stdout(io.StringIO()):
        svc = build_service(parse_serve_opt([
            "--model_path", root, "--load_model_id", "review_net_resnet", "--serve_dtype",
            "float32", "--beam_size", str(BEAM), "--serve_batch_size", str(RAW_BATCH),
            "--backbone_weights", weights]))
    httpd = None
    replies, latency = [None] * RAW_REQUESTS, [None] * RAW_REQUESTS
    try:
        svc.warmup()
        httpd = run_server(svc, "127.0.0.1", 0)
        port = httpd.server_address[1]

        def client(i):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                t0 = time.perf_counter()
                conn.request("POST", "/caption_image", body=bodies[i],
                             headers={"Content-Type": "image/jpeg"})
                r = conn.getresponse()
                replies[i] = (r.status, json.loads(r.read()))
                latency[i] = time.perf_counter() - t0
                conn.close()
            except Exception as e:  # recorded, then judged below
                replies[i] = (None, repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(RAW_REQUESTS)]
        reset_counters(counters)
        t0 = time.perf_counter()
        with recorder.run("caption_image"):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = read_counters(counters, "/caption_image")
        stats = dict(svc.server.stats)
    finally:
        if httpd is not None:
            httpd.shutdown()
        svc.close()
        if httpd is not None:
            httpd.server_close()
    bad = [(f, r) for f, r in zip(files, replies) if r is None or r[0] != 200]
    if bad:
        raise AssertionError(f"/caption_image: {len(bad)} bad replies, e.g. {bad[0]}")
    expect = (per_batch["review_net_resnet"] * stats["batches"], 0)
    if launches != expect or recorder.totals("caption_image") != expect:
        raise AssertionError(f"/caption_image: launches {launches} over {stats['batches']} "
                             f"batches, expected {expect}")
    differ = [f for f, (_, r) in zip(files, replies) if r["caption"] != want[f]]
    if differ:
        raise AssertionError(f"/caption_image: {len(differ)} of {RAW_REQUESTS} captions differ "
                             f"from eval --image_folder's, e.g. {differ[0]}")
    lat = sorted(x * 1e3 for x in latency)
    q = statistics.quantiles(lat, n=20)
    out = dict(requests=RAW_REQUESTS, wall_s=wall, p50_ms=statistics.median(lat), p95_ms=q[18],
               launches=launches, stats=stats)
    log(f"raw images /caption_image: {RAW_REQUESTS} concurrent requests in {wall:.3f} s, "
        f"captions equal to eval --image_folder's for the same files; latency p50 "
        f"{out['p50_ms']:.1f} ms, p95 {out['p95_ms']:.1f} ms; launches {launches} over "
        f"{stats['batches']} batches; server stats {stats} on {card}")
    return out


def raw_images(torch, aa, card, counters):
    """Phase 12: raw images to captions (backbones, the extract CLI, eval
    --image_folder, /caption_image), on files under build/ deleted when
    done. -> (results, forward site rows, the phase's shape recorder)."""
    import tempfile

    t0 = time.perf_counter()
    out = {"backbones": backbone_phase(torch, card)}
    rows = check_attention_kernel(torch, aa, raw_image_sites(RAW_BATCH),
                                  (torch.float32, torch.bfloat16))
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    free_gb = shutil.disk_usage(build).free / 1e9
    if free_gb < RAW_FREE_GB:
        raise AssertionError(f"raw images: {free_gb:.1f} GB free under {build}, "
                             f"{RAW_FREE_GB} GB needed")
    root = tempfile.mkdtemp(prefix="raw_", dir=build)
    recorder = ShapeRecorder(aa)
    try:
        images = os.path.join(root, "images")
        os.makedirs(images)
        write_raw_images(images)
        weights = os.path.join(root, "resnet101.pth")
        write_resnet101_weights(torch, weights)
        out["extract"] = extract_phase(torch, card, root, images, weights)
        per_batch = raw_image_models(torch, root)
        out["eval"] = eval_folder_phase(torch, card, counters, recorder, root, images, weights,
                                        per_batch)
        out["serve"] = caption_image_phase(torch, card, counters, recorder, root, images,
                                           weights, per_batch,
                                           out["eval"]["review_net_resnet"]["captions"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # every launch of the two runs was at a shape checked above
    checked = {("float32", G, N, A, D) for _, G, N, A, D, _ in raw_image_sites(RAW_BATCH)}
    if set(recorder.fwd) - checked or recorder.bwd:
        raise AssertionError(f"raw images: launches at unchecked shapes {set(recorder.fwd)}")
    out["seconds"] = time.perf_counter() - t0
    log(f"raw images: phase 12 in {out['seconds']:.2f} s")
    return out, rows


def path_sums(site_rows, path):
    """ms, plain_ms and bound_ms summed over the launches of one path (one
    beam-3 batch, one train step or one SCST iteration), and bound / ms of
    the sum."""
    out = {k: sum(r[k] * r["launches"].get(path, 0) for r in site_rows)
           for k in ("ms", "plain_ms", "bound_ms")}
    out["launches"] = sum(r["launches"].get(path, 0) for r in site_rows)
    out["bound_over_ms"] = out["bound_ms"] / out["ms"]
    return out


def main():
    # ---- 1. device
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if not os.path.isdir(os.path.join(REPO, "recurrent_fusion_network_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, REPO)
    card = card_line()
    log(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build
    from concurrent.futures import ThreadPoolExecutor

    from recurrent_fusion_network_torch.data import native as feature_io
    from recurrent_fusion_network_torch.kernels import additive_attention as aa
    from recurrent_fusion_network_torch.kernels import build
    from recurrent_fusion_network_torch.rewards import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # g++ beside the nvcc processes
        host = [pool.submit(lib.build) for lib in (native, feature_io)]
        logs = build.build_all()
        for job in host:
            job.result()
    log(f"build: {sorted(logs)}, {native.LIB.name} and {feature_io.LIBRARY.path.name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")

    # ---- 3. kernels vs plain
    from recurrent_fusion_network_torch.models import RecurrentFusionModel

    model = flagship(RecurrentFusionModel)
    sites = attention_sites(model)
    if per_path(sites, "serve") != 64 or per_path(sites, "train") != 65:
        raise AssertionError(f"call sites {sites} do not add up to 64 launches per "
                             f"batch and 65 per train step")
    rows = check_attention_kernel(torch, aa, sites, (torch.float32, torch.bfloat16))

    # ---- 4. slice
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    torch.cuda.synchronize()
    log(f"slice: flagship params initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    check_plain_vs_kernel_tokens(torch, model, params)
    launches, _ = serve_over_http(torch, model, params, [aa])

    # ---- 5. throughput
    solo_rate, _, _ = throughput(torch, model, params, card)
    del params
    torch.cuda.empty_cache()

    # ---- 6. train
    tsites = train_sites(model, TRAIN_ROWS)
    if per_path(tsites, "train") != 65:
        raise AssertionError(f"train call sites {tsites} do not add up to 65 per step")
    bwd_rows = check_attention_backward(torch, aa, tsites, (torch.float32, torch.bfloat16))
    f32_check = check_train_kernel_vs_plain(torch, model)
    trained = train_bf16(torch, model, card, [aa])

    # ---- 7. SCST
    fwd_sites, rl_bwd_sites = scst_sites(model)
    if per_path(fwd_sites, "scst") != 130 or per_path(rl_bwd_sites, "scst") != 65:
        raise AssertionError(f"SCST call sites do not add up to 130 + 65 per iteration: "
                             f"{fwd_sites} {rl_bwd_sites}")
    scst_rows = check_attention_kernel(torch, aa, fwd_sites, (torch.float32,))
    scst_bwd_rows = check_attention_backward(torch, aa, rl_bwd_sites, (torch.float32,))
    t0 = time.perf_counter()
    scorer = cider_scorer()
    log(f"scst: CIDEr-D scorer with 1,000,000 df entries, engine {scorer.engine}, built "
        f"in {time.perf_counter() - t0:.2f} s")
    rl_check = check_rl_kernel_vs_plain(torch, model, scorer)
    scst_on, infos = train_scst(torch, model, scorer, card, [aa], overlap=1)
    params, state = infos["final_params"], infos["final_opt_state"]
    del infos
    split = scst_split_and_profile(torch, model, scorer, params, state, card)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params, state
    torch.cuda.empty_cache()
    scst_off, _ = train_scst(torch, model, scorer, card, [aa], overlap=0)
    log(f"scst: images/s rl_overlap=1 {scst_on['images_per_s']:.1f}, rl_overlap=0 "
        f"{scst_off['images_per_s']:.1f}; peak memory {peak_gb:.2f} GB (train_rl and the "
        f"serial iterations) on {card}")
    scst_launches = {k: scst_on["launches"][k] + scst_off["launches"][k]
                     for k in scst_on["launches"]}
    torch.cuda.empty_cache()

    # ---- 8. drivers
    t0 = time.perf_counter()
    recorder = ShapeRecorder(aa)
    driven = drivers(torch, model, card, [aa], recorder)
    torch.cuda.empty_cache()
    log(f"drivers: phase 8's runs in {time.perf_counter() - t0:.2f} s; attention shapes "
        f"met: {len(recorder.fwd)} forward, {len(recorder.bwd)} backward")
    driver_runs = [driven["xe"], driven["scst_overlap_1"], driven["scst_overlap_0"]]
    driver_fwd = sum(r["launches"][0] for r in driver_runs) + driven["eval"]["launches"][0]
    driver_bwd = sum(r["launches"][1] for r in driver_runs)

    # ---- 9. models
    rn_rows, rn_bwd_rows, driven_models = models_phase(torch, aa, scorer, card)
    torch.cuda.empty_cache()

    # ---- 10. fleets and the ensemble
    fleet = fleets(torch, aa, model, card, [aa], recorder, solo_rate)
    fleet_launches = {run: recorder.totals(run) for run in PHASE10_RUNS}
    fleet_fwd = sum(f for f, _ in fleet_launches.values())
    fleet_bwd = sum(b for _, b in fleet_launches.values())
    torch.cuda.empty_cache()

    # ---- 11. remat, the three optimizers, the data front
    p11 = phase11(torch, aa, model, card, recorder)
    remat = p11["remat"]
    p11_launches = {
        "remat_off": tuple(map(sum, zip(remat["off"]["launches"],
                                        remat["off_again"]["launches"]))),
        "remat_full": remat["full"]["launches"], "remat_save_ctx": remat["save_ctx"]["launches"],
        "optimizers": p11["optimizers"]["launches"],
        "front_xe": p11["front"]["xe"]["launches"], "front_scst": p11["front"]["scst"]["launches"]}
    p11_fwd = sum(f for f, _ in p11_launches.values())
    p11_bwd = sum(b for _, b in p11_launches.values())

    # ---- 12. raw images: the backbones, the extract CLI, eval --image_folder,
    # /caption_image
    p12, raw_rows = raw_images(torch, aa, card, [aa])
    p12_launches = {f"image_folder_{run}": r["launches"][0] for run, r in p12["eval"].items()}
    p12_launches["caption_image"] = p12["serve"]["launches"][0]
    p12_fwd = sum(p12_launches.values())
    raw_batch = dict(path_sums([r for r in raw_rows if r["dtype"] == "float32"], "image_folder"),
                     dtype="float32")
    torch.cuda.empty_cache()

    # both kernels against their plain versions at every shape of phases 8,
    # 10 and 11's CLI runs
    t0 = time.perf_counter()
    drv_rows, drv_bwd_rows = check_driver_sites(
        torch, aa, recorder, {"drivers": ("xe", "eval", "scst_overlap_1", "scst_overlap_0"),
                              "fleets": PHASE10_RUNS, "front": ("front_xe", "front_scst")})
    log(f"drivers, fleets and data front: {len(recorder.fwd)} forward and "
        f"{len(recorder.bwd)} backward shapes checked against the plain versions in "
        f"{time.perf_counter() - t0:.2f} s")

    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    bwd16 = [r for r in bwd_rows if r["dtype"] == "bfloat16"]
    # phase 11's remat'd bf16 step at B = 512 has the train step's sites: "full"
    # launches each forward twice (the recompute), "save_ctx" once
    for r in bf16:
        r["launches"].update(remat_full=2 * r["launches"].get("train", 0),
                             remat_save_ctx=r["launches"].get("train", 0))
    for r in bwd16:
        r["launches"].update(remat_full=r["launches"].get("train", 0),
                             remat_save_ctx=r["launches"].get("train", 0))
    serve, train_fwd = path_sums(bf16, "serve"), path_sums(bf16, "train")
    train_bwd = path_sums(bwd16, "train")
    remat_fwd = {p: path_sums(bf16, p) for p in ("remat_full", "remat_save_ctx")}
    remat_bwd = {p: path_sums(bwd16, p) for p in ("remat_full", "remat_save_ctx")}
    front_fwd = {run: path_sums(drv_rows, run) for run in ("front_xe", "front_scst")}
    front_bwd = {run: path_sums(drv_bwd_rows, run) for run in ("front_xe", "front_scst")}
    scst_fwd, scst_bwd = path_sums(scst_rows, "scst"), path_sums(scst_bwd_rows, "scst")
    eval_fwd = path_sums(drv_rows, "eval")
    drivers_fwd, drivers_bwd = path_sums(drv_rows, "drivers"), path_sums(drv_bwd_rows, "drivers")
    # per phase-10 run: the XE fleet and the SCST fleet (whole runs, their
    # evals included), the ensemble CLI's batch (one batch of 100 test images,
    # twice under flip) and the 4-member B = 512 ensemble (5 batches)
    fleet_fwd_sums = {run: path_sums(drv_rows, run) for run in PHASE10_RUNS}
    fleet_bwd_sums = {run: path_sums(drv_bwd_rows, run) for run in ("fleet_xe", "fleet_scst")}
    for sums, dtype in ((serve, "bfloat16"), (train_fwd, "bfloat16"),
                        (train_bwd, "bfloat16"), (scst_fwd, "float32"),
                        (scst_bwd, "float32"), (eval_fwd, "bfloat16"),
                        (drivers_fwd, "bfloat16+float32"), (drivers_bwd, "bfloat16+float32"),
                        *((fleet_fwd_sums[r], "float32" if r == "fleet_scst" else "bfloat16")
                          for r in PHASE10_RUNS),
                        (fleet_bwd_sums["fleet_xe"], "bfloat16"),
                        (fleet_bwd_sums["fleet_scst"], "float32"),
                        *((x, "bfloat16") for x in (*remat_fwd.values(), *remat_bwd.values(),
                                                    front_fwd["front_xe"],
                                                    front_bwd["front_xe"])),
                        (front_fwd["front_scst"], "float32"),
                        (front_bwd["front_scst"], "float32")):
        sums["dtype"] = dtype
    rn_fwd, rn_bwd, model_fwd, model_bwd = models_sums(rn_rows, rn_bwd_rows, driven_models)
    if (eval_fwd["launches"], drivers_fwd["launches"], drivers_bwd["launches"]) != (
            driven["eval"]["launches"][0], driver_fwd, driver_bwd):
        raise AssertionError("drivers: the checked sites do not add up to phase 8's launches")
    if (path_sums(drv_rows, "fleets")["launches"], path_sums(drv_bwd_rows, "fleets")["launches"]) \
            != (fleet_fwd, fleet_bwd):
        raise AssertionError("fleets: the checked sites do not add up to phase 10's launches")
    if (path_sums(drv_rows, "front")["launches"], path_sums(drv_bwd_rows, "front")["launches"]) \
            != tuple(map(sum, zip(p11_launches["front_xe"], p11_launches["front_scst"]))):
        raise AssertionError("data front: the checked sites do not add up to phase 11's launches")
    for p in ("remat_full", "remat_save_ctx"):
        steps = REMAT_STEPS
        if (remat_fwd[p]["launches"] * steps, remat_bwd[p]["launches"] * steps) \
                != p11_launches[p]:
            raise AssertionError(f"{p}: the train sites do not add up to phase 11's launches")
    rows = rows + scst_rows + drv_rows + rn_rows + raw_rows
    bwd_rows = bwd_rows + scst_bwd_rows + drv_bwd_rows + rn_bwd_rows
    kernels = [{
        "name": "additive_attention_fwd",
        "route": "cuda",
        "source": "recurrent_fusion_network_torch/csrc/additive_attention.cu",
        "replaces": "recurrent_fusion_network_tpu/ops/attention.py:46",
        "launches": launches["additive_attention"]
        + trained["launches"]["additive_attention_fwd"]
        + scst_launches["additive_attention_fwd"] + driver_fwd + sum(model_fwd.values())
        + fleet_fwd + p11_fwd + p12_fwd,
        # "eval": the eval CLI's run (one batch of 100 test images);
        # "drivers": all of phase 8's CLI runs, their eval batches included;
        # "<model>_<path>": phase 9's HTTP serving, XE and SCST runs;
        # phase 10's runs: the XE and SCST fleets (their evals included),
        # the ensemble CLI without, with and again without flip, the B = 512
        # ensemble
        "launches_by_path": {"serve": launches["additive_attention"],
                             "train": trained["launches"]["additive_attention_fwd"],
                             "scst": scst_launches["additive_attention_fwd"],
                             "eval": driven["eval"]["launches"][0],
                             "drivers": driver_fwd, **model_fwd,
                             **{run: f for run, (f, _) in fleet_launches.items()},
                             **{run: f for run, (f, _) in p11_launches.items()},
                             **p12_launches},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per beam-3 bf16 batch at B = 512: the sum over its 64 launches
        "ms": serve["ms"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bf16) else "operations",
        "library_ms": None,  # no single PyTorch call computes additive attention
        # the same sums per bf16 train step at B = 512 (65 launches), per
        # f32 SCST iteration at B = 256 (130 launches), per bf16 eval batch
        # of 100 images (the eval CLI's run), over all of phase 8's
        # launches at the shapes they had, and per ReviewNet beam-3 bf16
        # batch at B = 512 (24), bf16 XE step at 500 rows (25) and f32 SCST
        # iteration at B = 256 (50)
        # phase 11: per remat'd bf16 step at B = 512 (130 launches under
        # "full", 65 under "save_ctx"), and over the data front's XE and
        # SCST runs on the sharded stores; phase 12: per f32 beam-3 batch of
        # 16 images of ReviewNet on the resnet grid (24 launches), in eval
        # --image_folder and /caption_image alike
        "by_path": {"serve": serve, "train": train_fwd, "scst": scst_fwd, "eval": eval_fwd,
                    "drivers": drivers_fwd, **rn_fwd, **fleet_fwd_sums, **remat_fwd,
                    **front_fwd, "raw_image_batch": raw_batch},
        "ok": all(r["ok"] and r["bitwise_repeat"] for r in rows),
        "sites": rows,
    }, {
        "name": "additive_attention_bwd",
        "route": "cuda",
        "source": "recurrent_fusion_network_torch/csrc/additive_attention_bwd.cu",
        # the gradient of attend under jax.value_and_grad in make_train_step
        "replaces": "recurrent_fusion_network_tpu/ops/attention.py:46",
        "launches": trained["launches"]["additive_attention_bwd"]
        + scst_launches["additive_attention_bwd"] + driver_bwd + sum(model_bwd.values())
        + fleet_bwd + p11_bwd,
        "launches_by_path": {"train": trained["launches"]["additive_attention_bwd"],
                             "scst": scst_launches["additive_attention_bwd"],
                             "drivers": driver_bwd, **model_bwd,
                             "fleet_xe": fleet_launches["fleet_xe"][1],
                             "fleet_scst": fleet_launches["fleet_scst"][1],
                             **{run: b for run, (_, b) in p11_launches.items()}},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        # errors relative to the largest plain value of each output
        "max_rel_err": max(r["max_rel_err"] for r in bwd_rows),
        # per bf16 train step at B = 512: the sum over its 65 launches
        "ms": train_bwd["ms"],
        "plain_ms": train_bwd["plain_ms"],
        "bound_ms": train_bwd["bound_ms"],
        "by_path": {"train": train_bwd, "scst": scst_bwd, "drivers": drivers_bwd, **rn_bwd,
                    **fleet_bwd_sums, **remat_bwd, **front_bwd},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bwd16) else "operations",
        "library_ms": None,  # no single PyTorch call computes its gradient
        "ok": all(r["ok"] and r["bitwise_repeat"] for r in bwd_rows),
        "sites": bwd_rows,
    }]
    log("train summary: " + json.dumps({**f32_check, **trained}))
    log("scst summary: " + json.dumps({**rl_check, "overlap_on": scst_on,
                                        "overlap_off": scst_off, **split,
                                        "peak_gb": peak_gb}))
    log("drivers summary: " + json.dumps(driven))
    log("models summary: " + json.dumps(driven_models))
    log("fleets summary: " + json.dumps(fleet))
    log("phase 11 summary: " + json.dumps(p11))
    for r in p12["eval"].values():
        r.pop("captions")
    log("phase 12 summary: " + json.dumps(p12))
    for k in kernels:
        for path, sums in k["by_path"].items():
            log(f"kernel {k['name']} per {sums['dtype']} {path} path ({sums['launches']} "
                f"launches): "
                f"ms {sums['ms']:.4f} plain_ms {sums['plain_ms']:.4f} bound_ms "
                f"{sums['bound_ms']:.4f} bound/ms {sums['bound_over_ms']:.3f}")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
