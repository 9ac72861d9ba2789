"""Chip smoke test of the PyTorch / CUDA port on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. device:  requires CUDA, prints the card's name and power limit, and
              turns TF32 off for matmuls and cuDNN;
  2. build:   compiles every kernel of the port from csrc/ with nvcc for
              sm_90a (one nvcc per source, all started together) and, beside
              them, the native CIDEr-D scorer (csrc/cider_d.cpp) with g++;
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
              per SCST iteration, ShowTell none, none on the scalar path.
The line before the last is the kernels JSON, the last line the device JSON.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
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


def write_driver_dataset(root, model, seed=0):
    """A data set at the flagship widths, in the files Dataset.from_files
    and the packed feature stores read: cocotalk.json (9,487 words; 300 /
    100 / 100 train / val / test images), npz labels (5 captions x 16
    tokens per image, half their words from a caption lexicon), a top-words
    pickle, and per registry encoder a packed/ store of original_fc.npy and
    original_att.npy (seeded random f32). -> (argv of the data flags, GB)."""
    import pickle

    import numpy as np

    from recurrent_fusion_network_torch import feat_registry

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
    n_bytes = 0
    for info in feat_registry.feat_array_info(data_root):
        store = os.path.join(data_root, info.name, "packed")
        os.makedirs(store)
        with open(os.path.join(store, "ids.json"), "w") as f:
            json.dump(ids, f)
        for kind, shape in (("fc", (info.fc_feat_size,)),
                            ("att", (info.att_num, info.att_feat_size))):
            arr = np.lib.format.open_memmap(os.path.join(store, f"original_{kind}.npy"),
                                            mode="w+", dtype=np.float32,
                                            shape=(len(ids),) + shape)
            for lo in range(0, len(ids), 50):
                arr[lo:lo + 50] = g.standard_normal((min(50, len(ids) - lo),) + shape,
                                                    dtype=np.float32)
            arr.flush()
            n_bytes += arr.nbytes
            del arr
    argv = ["--caption_model", "recurrent_fusion_model", "--feature_type", "feat_array",
            "--data_root", data_root]
    for k, v in paths.items():
        argv += [f"--{k}", v]
    return argv, n_bytes / 1e9


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

    def wrap(self, build_loader):
        def build(*a, **kw):
            loader = build_loader(*a, **kw)
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


def check_driver_sites(torch, aa, recorder):
    """Both kernels against their plain versions at every shape phase 8's
    runs gave them, each in its own dtype, at the tolerances of phases 3
    and 6 with a bitwise repeat; each row's launches per run and in all
    ("drivers")."""
    fwd_rows, bwd_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        fwd = [(f"drivers_G{G}_N{N}_A{A}_D{D}", G, N, A, D,
                dict(runs, drivers=sum(runs.values())))
               for (dt, G, N, A, D), runs in sorted(recorder.fwd.items()) if dt == dname]
        bwd = [(f"drivers_G{G}_N{N}_A{A}_D{D}", G, N, A, D, need,
                dict(runs, drivers=sum(runs.values())))
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
            recorder.run(run):
        out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters, what)
    if launches != expect or recorder.totals(run) != expect:
        raise AssertionError(f"{what}: launches (fwd, bwd) {launches}, by shape "
                             f"{recorder.totals(run)}, expected {expect}")
    return out, dict(probe.summary(), wall_s=wall, metric_s=metric_s, launches=launches,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)


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

    from recurrent_fusion_network_torch.kernels import additive_attention as aa
    from recurrent_fusion_network_torch.kernels import build
    from recurrent_fusion_network_torch.rewards import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        cider = pool.submit(native.build)
        logs = build.build_all()
        cider.result()
    log(f"build: {sorted(logs)} and {native.LIB.name} in {time.perf_counter() - t0:.2f} s")
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
    throughput(torch, model, params, card)
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
    drv_rows, drv_bwd_rows = check_driver_sites(torch, aa, recorder)
    log(f"drivers: phase 8 in {time.perf_counter() - t0:.2f} s with its site checks")

    # ---- 9. models
    rn_rows, rn_bwd_rows, driven_models = models_phase(torch, aa, scorer, card)

    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    bwd16 = [r for r in bwd_rows if r["dtype"] == "bfloat16"]
    serve, train_fwd = path_sums(bf16, "serve"), path_sums(bf16, "train")
    train_bwd = path_sums(bwd16, "train")
    scst_fwd, scst_bwd = path_sums(scst_rows, "scst"), path_sums(scst_bwd_rows, "scst")
    eval_fwd = path_sums(drv_rows, "eval")
    drivers_fwd, drivers_bwd = path_sums(drv_rows, "drivers"), path_sums(drv_bwd_rows, "drivers")
    for sums, dtype in ((serve, "bfloat16"), (train_fwd, "bfloat16"),
                        (train_bwd, "bfloat16"), (scst_fwd, "float32"),
                        (scst_bwd, "float32"), (eval_fwd, "bfloat16"),
                        (drivers_fwd, "bfloat16+float32"), (drivers_bwd, "bfloat16+float32")):
        sums["dtype"] = dtype
    rn_fwd, rn_bwd, model_fwd, model_bwd = models_sums(rn_rows, rn_bwd_rows, driven_models)
    if (eval_fwd["launches"], drivers_fwd["launches"], drivers_bwd["launches"]) != (
            driven["eval"]["launches"][0], driver_fwd, driver_bwd):
        raise AssertionError("drivers: the checked sites do not add up to phase 8's launches")
    rows = rows + scst_rows + drv_rows + rn_rows
    bwd_rows = bwd_rows + scst_bwd_rows + drv_bwd_rows + rn_bwd_rows
    kernels = [{
        "name": "additive_attention_fwd",
        "route": "cuda",
        "source": "recurrent_fusion_network_torch/csrc/additive_attention.cu",
        "replaces": "recurrent_fusion_network_tpu/ops/attention.py:46",
        "launches": launches["additive_attention"]
        + trained["launches"]["additive_attention_fwd"]
        + scst_launches["additive_attention_fwd"] + driver_fwd + sum(model_fwd.values()),
        # "eval": the eval CLI's run (one batch of 100 test images);
        # "drivers": all of phase 8's CLI runs, their eval batches included;
        # "<model>_<path>": phase 9's HTTP serving, XE and SCST runs
        "launches_by_path": {"serve": launches["additive_attention"],
                             "train": trained["launches"]["additive_attention_fwd"],
                             "scst": scst_launches["additive_attention_fwd"],
                             "eval": driven["eval"]["launches"][0],
                             "drivers": driver_fwd, **model_fwd},
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
        "by_path": {"serve": serve, "train": train_fwd, "scst": scst_fwd, "eval": eval_fwd,
                    "drivers": drivers_fwd, **rn_fwd},
        "ok": all(r["ok"] and r["bitwise_repeat"] for r in rows),
        "sites": rows,
    }, {
        "name": "additive_attention_bwd",
        "route": "cuda",
        "source": "recurrent_fusion_network_torch/csrc/additive_attention_bwd.cu",
        # the gradient of attend under jax.value_and_grad in make_train_step
        "replaces": "recurrent_fusion_network_tpu/ops/attention.py:46",
        "launches": trained["launches"]["additive_attention_bwd"]
        + scst_launches["additive_attention_bwd"] + driver_bwd + sum(model_bwd.values()),
        "launches_by_path": {"train": trained["launches"]["additive_attention_bwd"],
                             "scst": scst_launches["additive_attention_bwd"],
                             "drivers": driver_bwd, **model_bwd},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        # errors relative to the largest plain value of each output
        "max_rel_err": max(r["max_rel_err"] for r in bwd_rows),
        # per bf16 train step at B = 512: the sum over its 65 launches
        "ms": train_bwd["ms"],
        "plain_ms": train_bwd["plain_ms"],
        "bound_ms": train_bwd["bound_ms"],
        "by_path": {"train": train_bwd, "scst": scst_bwd, "drivers": drivers_bwd, **rn_bwd},
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
