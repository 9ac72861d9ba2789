"""Chip smoke test of the PyTorch / CUDA port on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. device:  requires CUDA, prints the card's name and power limit, and
              turns TF32 off for matmuls and cuDNN;
  2. build:   compiles every kernel of the port from csrc/ with nvcc for
              sm_90a (one nvcc per source, all started together);
  3. kernels: each kernel against its plain PyTorch version at the shapes
              the serving path gives it (flagship widths, B = 512, beam 3),
              in f32 and bf16, with errors, device times (torch.profiler;
              CUDA-event times beside them) and the bound (bytes / 3.35 TB/s
              vs operations / 67 TFLOP/s f32);
  4. slice:   the flagship RecurrentFusionModel (tied keys, random weights
              from a seeded torch.Generator): f32 beam-3 tokens with the
              kernel equal those with the plain version; then a bf16
              CaptionService (batch 16, beam 3) behind the threaded HTTP
              front end answers concurrent /caption requests with npz bodies,
              with the launch counters reset just before and read just
              after (64 launches of additive_attention_fwd per batch);
  5. throughput: B = 512 beam-3 bf16 decodes through pipelined_map, one of
              them queued under CUDA sync debug mode "error" (no host sync
              inside the decode), then one batch under torch.profiler.
The line before the last is the kernels JSON, the last line the device JSON.
"""

from __future__ import annotations

import io
import json
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
    """(name, G, N, A, D, launches per beam-3 batch) of every call site."""
    S0, S, L = model.num_review_steps_0, model.num_review_steps, model.seq_length
    sites = [(f"stage1_enc{j}", 1, BATCH, a, d, S0)
             for j, (a, d) in enumerate(zip(model.att_nums, model.att_feat_sizes))]
    sites.append(("stage2", model.num_feat_array, BATCH, S, model.rnn_size, S))
    sites.append(("decoder", 1, BATCH * BEAM, S, model.rnn_size, L))
    return sites


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


def device_ms(torch, fn, input_sets, reps=20):
    """Mean device time per call: the summed durations of the device
    activities (kernels, copies) that `reps` calls put on the card, from
    torch.profiler, so the host's launch gaps are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*input_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*input_sets[i % len(input_sets)])
        torch.cuda.synchronize()
    total_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total_us / reps / 1e3


def check_attention_kernel(torch, aa, sites):
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, G, N, A, D, per_batch in sites:
            def make():
                def r(*shape, scale=1.0):
                    x = torch.randn(*shape, generator=gen, device=DEVICE) * scale
                    return x.to(dtype)
                return (r(G * N, HID), r(G * N, A, HID), r(G, HID, scale=0.06),
                        r(G, scale=0.06), r(G * N, A, D))

            ins = make()
            z, w = aa.additive_attention(*ins)
            torch.cuda.synchronize()
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
            ms = device_ms(torch, aa.additive_attention, sets)
            plain_ms = device_ms(torch, aa.additive_attention_ref, sets, reps=5)
            ev_ms = event_ms(torch, aa.additive_attention, sets)
            bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
            row = dict(site=name, dtype=dname, shape=[G, N, A, HID, D],
                       launches_per_batch=per_batch, max_abs_err=err, max_rel_err=rel,
                       ok=ok, ms=ms, plain_ms=plain_ms, event_ms=ev_ms,
                       bound_ms=bound_ms,
                       bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                       else "operations", bytes=nbytes)
            log(f"kernel additive_attention_fwd {name} {dname} G={G} N={N} A={A} "
                f"D={D}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                f"(rtol {tol['rtol']}, atol {tol['atol']}) ok={ok} ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
                f"(events incl. launch gaps: {ev_ms:.4f} ms)")
            if not ok:
                raise AssertionError(f"additive_attention_fwd disagrees at {name} {dname}")
            results.append(row)
            del sets, ins, z, w, zr, wr
    return results


def features(torch, model, batch, gen, dtype):
    fcs = [torch.randn(batch, d, generator=gen, device=DEVICE).to(dtype)
           for d in model.fc_feat_sizes]
    atts = [torch.randn(batch, a, d, generator=gen, device=DEVICE).to(dtype)
            for a, d in zip(model.att_nums, model.att_feat_sizes)]
    return fcs, atts


def check_plain_vs_kernel_tokens(torch, model, params):
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
    log(f"slice f32 beam-3 (B=8): tokens identical with and without the kernel, "
        f"top_p max abs diff {lp_err:.3e}")


def serve_over_http(torch, model, params, counters):
    import http.client

    import numpy as np

    from recurrent_fusion_network_torch.decoding.http_serve import (
        CaptionService,
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
        for _ in range(N_REQUESTS):
            buf = io.BytesIO()
            np.savez(buf, **{f"fc_{i}": rng.standard_normal(d).astype(np.float32)
                             for i, d in enumerate(model.fc_feat_sizes)},
                     **{f"att_{i}": rng.standard_normal((a, d)).astype(np.float32)
                        for i, (a, d) in enumerate(zip(model.att_nums,
                                                       model.att_feat_sizes))})
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
            c.launches = 0  # main path starts here
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
        stats = dict(svc.server.stats)
    finally:
        if httpd is not None:
            httpd.shutdown()
        svc.close()
        if httpd is not None:
            httpd.server_close()
    bad = [r for r in replies if r is None or r[0] != 200 or not r[1].get("caption")
           or not np.isfinite(r[1].get("logprob", float("nan")))]
    log(f"slice http: {N_REQUESTS} concurrent /caption requests in {wall:.3f} s, "
        f"{N_REQUESTS - len(bad)} answered 200 with a caption; server stats {stats}; "
        f"example {replies[0][1] if replies[0] else None}")
    if bad:
        raise AssertionError(f"{len(bad)} bad HTTP replies, e.g. {bad[0]}")
    if stats["requests"] != N_REQUESTS or stats["padded_rows"] == 0:
        raise AssertionError(f"expected {N_REQUESTS} requests incl. a partial batch: {stats}")
    per_batch = 64
    if launches["additive_attention"] != per_batch * stats["batches"]:
        raise AssertionError(
            f"additive_attention_fwd launched {launches['additive_attention']} times "
            f"for {stats['batches']} batches (expected {per_batch} per batch)")
    log(f"slice launches: {launches} over {stats['batches']} batches "
        f"({per_batch} additive_attention_fwd launches per batch)")
    return launches, stats


def throughput(torch, model, params, card):
    """Timed B = 512 beam-3 bf16 decodes through pipelined_map, then one
    profiled decode: device busy time by kernel and the device's idle share."""
    from torch.autograd import DeviceType
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
    log("throughput: a B=512 decode queued under sync debug mode 'error': "
        "no host sync inside the decode")
    t0 = time.perf_counter()
    n = 0
    for _, seq in pipelined_map(decode, (batches[i % 2] for i in range(n_timed)), depth=2):
        n += seq.cpu().shape[0]
    dt = time.perf_counter() - t0
    rate = n / dt
    log(f"throughput: {rate:.1f} captions/s (beam 3, bf16, B={BATCH}, {n_timed} "
        f"batches through pipelined_map depth 2, {dt:.4f} s, "
        f"{dt / n_timed * 1e3:.2f} ms per batch) on {card}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        decode(batches[1]).cpu()
        wall_ms = (time.perf_counter() - t1) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        log("profile: the profiler recorded no device events; device time not measured")
        return rate
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for s0, e0, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0)
        if cur_e is None or s0 > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy = (busy + cur_e - cur_s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile: one B={BATCH} beam-3 bf16 decode: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}, {len(spans)} device events")
    for name, us in top:
        log(f"profile:   {us / 1e3:8.3f} ms  {name[:110]}")
    return rate


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
    from recurrent_fusion_network_torch.kernels import additive_attention as aa
    from recurrent_fusion_network_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")

    # ---- 3. kernels vs plain
    from recurrent_fusion_network_torch.models import RecurrentFusionModel

    model = flagship(RecurrentFusionModel)
    sites = attention_sites(model)
    if sum(s[-1] for s in sites) != 64:
        raise AssertionError(f"call sites {sites} do not add up to 64 launches per batch")
    rows = check_attention_kernel(torch, aa, sites)

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

    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    per_batch = lambda key: sum(r[key] * r["launches_per_batch"] for r in bf16)  # noqa: E731
    kernels = [{
        "name": "additive_attention_fwd",
        "route": "cuda",
        "source": "recurrent_fusion_network_torch/csrc/additive_attention.cu",
        "replaces": "recurrent_fusion_network_tpu/ops/attention.py:46",
        "launches": launches["additive_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per beam-3 bf16 batch at B = 512: the sum over its 64 launches
        "ms": per_batch("ms"),
        "plain_ms": per_batch("plain_ms"),
        "bound_ms": per_batch("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bf16) else "operations",
        "library_ms": None,  # no single PyTorch call computes additive attention
        "ok": all(r["ok"] for r in rows),
        "sites": rows,
    }]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
