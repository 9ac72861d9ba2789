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
              (rollout tokens, then the step's loss and grads); 5
              iterations through train_rl() with --rl_overlap 1 and again
              with 0, the launch counters reset just before and read just
              after each (130 + 65 launches per iteration, none on the
              scalar path), iteration time and images/s; serial iterations
              split into batch copy, rollout, host reward and grad step;
              one profiled iteration; peak memory;
  8. drivers: the training and evaluation CLIs on a data set at the flagship
              widths written once under build/ and read again by phases
              10, 14 and 16 (9,487 words, 300 / 100 / 100
              train / val / test images x 5 captions, packed stores of the
              five registry encoders, with the test images' flip
              features: 1.9 GB; 25 GB free asked for, as a
              flagship triple is 5.4 GB): main (bf16, 100 images x 5, 7
              steps, a boundary at 6 with beam-3 eval_split, the 8 metrics
              and the triples), eval of the best triple on the test split,
              main_rl (f32, 51 images x 5) warm-started from it, 7
              iterations with a boundary at 12, under --rl_overlap 1 and 0
              (cut from 21 to make room for phase 15).
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
              features of the 100 test images) main --n_seeds S (S =
              FLEET_SEEDS = 2, cut from 4 to make room for phase 15; bf16,
              100 images x 5, 6 steps, the boundary at 5), main_rl
              --n_seeds S warm-started from its best triples (f32, 51
              images x 5, iterations 0..5 counted from 0 as the JAX
              fleet counts, the boundary at 5),
              eval_ensemble --n_ranks S --rl_prefix 1 --beam_size 3 --dtype
              bfloat16 on the test images without, with and again without
              --eval_flip_ensemble 1, and an S-member bf16 B = 512 ensemble
              beside phase 5's solo rate. Counters reset before and read
              after each run: S x (65 + 65) per XE iteration, S x (130 +
              65) per SCST iteration, 129 per seed per eval batch, S x 64
              per ensemble batch (2S x 64 under flip); iteration ms (median
              and quartiles of the fetch gaps), ms per seed, the boundary's
              eval and triple seconds, peak memory at S and the S = 8 peak
              extrapolated from it (one seed's f32 params and moments per
              added seed);
 11. remat, optimizers, data front: (a) phase 6's B = 512 bf16 batch with
              dropout at the flagship rates (0.3, scripts/train_recurrent_
              fusion_model.sh) and ss_prob 0.3, 4 steps each without remat,
              under --remat_policy full and under save_ctx (and one more
              step without, the spread of two runs), from the same params
              and generator state: the first step's loss and every grad
              leaf against the run without remat (no further apart than the
              two runs without it), launches per step exactly 65 + 65, 130 +
              65 (the recompute launches each forward again) and 65 + 65
              (save_ctx keeps the reads' outputs), step ms (median of the
              last 3), the memory held at the end of the forward and the
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
              --remat_policy save_ctx --optim rmsprop, 7 steps, the
              boundary at 6) and main_rl --cider_df <prepro_ngrams' pickle>
              --load_lr 1 from its best triple (f32, 51 x 5, iterations
              7..12, the boundary at 12); exact launches, finite metrics.
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
              read just after each run; every launch's shape is one checked;
 13. serving front ends, the greedy-baseline reward, the runbook: (a)
              phase 4's flagship in bf16 (serve batch 16, beam 3) behind the
              asyncio front end, then the threading one: 64 keep-alive
              clients send the same 128 npz requests to each, two a
              connection; captions (one word per token) equal across the
              two and to the in-process
              decode of the same rows in batches of 16; 64 launches per
              decoded batch; req/s, latency p50 / p95, batches, padded rows;
              then the serve CLI over a flagship checkpoint with its default
              front end (asyncio) answers one request and exits 0 on SIGTERM
              within --drain_timeout; (b) get_self_critical_reward at phase
              7's shape (f32, B = 256): rewards equal compute_reward over
              model_sample's greedy tokens, 65 launches, rollout and reward
              ms; (c) DRY_RUN=1 bash recurrent_fusion_network_torch/scripts/
              run_coco.sh (NUM_SEEDS 2, DATA_DIR under build/, 40 GB free
              asked for) and again with STAGES=eval, every stage a port CLI
              on the card under this script's launch probe, in its own
              process forked by --probe-server after torch's import (each
              command's launches counted by shape in its process):
              ranks 0 and 1 hold their XE and rl_ triples, both eval logs
              finite metrics, seconds per stage; the SCST fleet counts from
              0 as the JAX fleet does (4 iterations a seed as the XE fleet's
              4 steps, 2 x 4 x 65 backward launches each, the rolling rl_
              triples iter 3 with rewards 0..2); the run's files deleted.
              Every shape of (a)-(c) is checked against the plain versions.
 14. SPICE rewards, orbax checkpoints, the trace window: (a) phase 7's
              SCST (f32, B = 256, 5 references a row, the native CIDEr-D
              engine) through train_rl with --spice_weight 1 --cider_weight
              1, 4 iterations with --spice_backend approx, then 4 with
              http against metrics.spice_server started in-process on an
              ephemeral loopback port: 130 + 65 launches an iteration, one
              SPICE hook a run, the http run's rewards equal to the approx
              scorer's on the same rollouts, finite losses, iteration ms and
              the reward's ms split into SPICE and CIDEr-D; then the S = 2
              SCST fleet, 2 iterations, approx; (b) on phase 8's data set
              (25 GB free asked for under build/orbax_*, deleted when
              done): main bf16 100 x 5 with --checkpoint_backend orbax
              --checkpoint_async 0 and 1, steps 0..10 with boundaries at
              5 and 10 (the async run's second save waits for the first
              one's write in flight), and with --checkpoint_backend pickle,
              steps 0..6 with the boundary at 5:
              each triple's bytes, the seconds until save_checkpoint returns
              and until its write is done, the step loop's stall at the
              boundary; eval and eval_ensemble of the sync run's -best DCP
              triple; a third run resumed from the sync run's step-5
              rolling DCP triple to step 10 (no boundary), its losses against the
              uninterrupted run's (bf16 tolerance of phase 6, bit for bit
              reported); (c) main with --profile_dir --profile_start 3
              --profile_steps 2 for 6 steps: one Chrome trace whose kernel
              events hold additive_attention_fwd and _bwd as often as the
              counters read for those 2 steps (65 + 65 each), the step ms
              inside and outside the window. Every shape of (a)-(c) is
              checked against the plain versions.
 15. data parallelism over torch.distributed: on a data set of phase 8's
              shapes (seed 2, written under build/dp_*, deleted when done), (a)
              the XE CLI (bf16, 100 x 5, steps 0..9, the boundary at 9)
              and main_rl from its best triple (f32, 51 x 5, 6 iterations)
              in this process, then both in one process under python -m
              torch.distributed.run --standalone --nproc_per_node 1 (an
              NCCL group of one, joined by each CLI in turn: the gradient
              all-reduce, rank 0's writes, a collective DCP save with
              --checkpoint_backend orbax), each under the launch probe:
              the losses bit for bit, the DCP triple reading back to the
              solo run's pickle tree leaf for leaf, the step ms of each
              (median and quartiles of 8 and 4 JSONL gaps); (b) the same
              global batches in this process and over two gloo ranks
              sharing cuda:0 (parallel.distributed.initialize(
              backend="gloo"), each rank a process of this script under
              --dp-pair-rank): XE f32 at B = 512 rows (256 a rank) and SCST
              f32 at B = 256 (128 a rank) for PAIR_STEPS = 2 steps (cut
              from 3 to make room for phase 17), losses within rtol
              1e-4 / atol 1e-6 (XE) and rtol 2e-4 / atol 1e-6 (SCST), the
              first step's grads leaf by leaf within the same (XE's reason
              heads and review cells, SWITCH_LEAVES, within atol 1e-5); the
              XE step's switches (each reason head's amax over the review
              steps, its hinge's terms) counted where the pair took the
              other side, and the solo step made to take the pair's choices
              matching the pair's grads on every leaf within rtol 1e-4 /
              atol 1e-6; each rank's launches equal to the single-process
              run's; an S = 2 fleet over the two ranks, each seed's losses
              and final params bit for bit the single-process fleet's; the
              same pair laid out as dp 1 x mp 2 (--num_mp_devices 2, the
              flagship's logit and embedding split 4744 / 4744): the XE f32
              run at 512 rows on each rank for 2 steps, the boundary at the
              last, its losses and the first step's gathered grads within
              rtol 1e-4 / atol 1e-6 of the single-process XE run's on every
              leaf, the final params and grads bit for bit on both ranks,
              65 + 65 launches a step a rank (and 65 + 64 for the
              boundary's eval), rank 0's triple the final params bit for
              bit; a SIGTERM to rank 1 alone while both train stops both
              at one boundary with exit 0, rank 0 writing the triple; (c)
              step ms per rank with the all-reduce's (the mp collectives')
              ms split out, peak GB per process, launches per rank against
              the single-process ones, and the NCCL pair across two cards
              where the machine has two (else a line saying it was not
              run). Every shape of (a) and (b) is checked against the plain
              versions.
 16. the device meshes (a single-process list of devices; here cuda:0
              twice, so no speed-up is possible): (b) a B = 512 beam-3 bf16
              CaptionServer on the mesh against the one-device server, the
              same 512 requests: tokens identical, 2 x 64 launches a batch,
              captions/s of both beside phase 5's; (c) eval_ensemble of two
              flagship f32 members on phase 8's 100 test images on the mesh
              against no mesh: predictions identical, 2 x 2 x 64 launches;
              (d) the diff-feat ensemble of five ReviewNets at published
              widths, member i on encoder i, through eval_ensemble on the
              same images (f32, beam 3): predictions with the kernels equal
              those with the plain versions, 5 x 24 launches, the 8 metrics
              finite. Counters reset just before and read just after each
              path; every shape is checked against the plain versions.
 17. the full-pipeline quality proxy: python -m recurrent_fusion_network_
              torch.pipeline_proxy --quick (the root pipeline_proxy.py on the
              port; its learnable 3-encoder corpus of 60 / 16 / 16 images,
              H = 96, A = 10 / 8 / 12, D = 64 / 48 / 56, 4 + 4 review steps,
              10 tokens, f32, the default untied profile) in this process:
              a PROXY_SEEDS = 2 XE fleet (120 steps at 8 images x 5), an
              SCST fleet from its best triples (40 iterations counted from
              0, ending at iter 40, train-idf CIDEr-D), each seed's greedy
              test CIDEr, the ensemble of the rl_ best triples. The
              counters reset just before and read just
              after: every XE step 27 + 27 launches, every SCST rollout 27 +
              0 and step 27 + 27, every eval batch 54 + 0 and ensemble batch
              2 x 27 + 0, adding up to the run's; none on the scalar path;
              every shape checked against the plain versions; finite CIDEr
              fields, SCST's params moved, the -best and rl_-best triples in
              place; the ordering gates printed as they came out (--quick
              asserts none, as in the root script); the wall seconds of the
              XE fleet, the SCST fleet, the test CIDEr and the ensemble.
The line before the last is the kernels JSON, the last line the device JSON.

``python3 chip_smoke.py --launch-probe LOG -m MODULE ARGS [--and-then -m
MODULE ARGS ...]`` runs each module in turn as ``python -m`` does and
appends its launches by shape to LOG (the world-1 CLI runs in phase 15);
``python3 chip_smoke.py --probe-server SOCK LOG`` forks one such probe for
each command a client sends to SOCK (the runbook's interpreter in phase
13);
``python3 chip_smoke.py --dp-pair-rank DIR`` is one rank of phase 15's
gloo pair.
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


def check_attention_kernel(torch, aa, sites, dtypes, hid=HID):
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    results = []
    for dtype in dtypes:
        dname = str(dtype).replace("torch.", "")
        for name, G, N, A, D, launches in sites:
            def make():
                def r(*shape, scale=1.0):
                    x = torch.randn(*shape, generator=gen, device=DEVICE) * scale
                    return x.to(dtype)
                return (r(G * N, hid), r(G * N, A, hid), r(G, hid, scale=0.06),
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
            ops = G * N * A * (4 * hid + 2 * D + 3)
            n_sets = max(1, min(8, -(-200_000_000 // nbytes)))
            sets = [ins] + [make() for _ in range(n_sets - 1)]
            times = site_times(torch, aa.additive_attention, aa.additive_attention_ref, sets)
            ms, plain_ms = times["ms"], times["plain_ms"]
            bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
            row = dict(site=name, dtype=dname, shape=[G, N, A, hid, D],
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


def check_attention_backward(torch, aa, sites, dtypes, hid=HID):
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
                q, keys, v, bv, values = (r(G * N, hid), r(G * N, A, hid),
                                          r(G, hid, scale=0.06), r(G, scale=0.06),
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
            ops = G * N * A * (9 * hid + (3 if need_dvalues else 2) * D)
            n_sets = max(1, min(8, -(-200_000_000 // nbytes)))
            sets = [ins] + [make() for _ in range(n_sets - 1)]
            times = site_times(torch, kernel, plain, sets)
            ms, plain_ms = times["ms"], times["plain_ms"]
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
            row = dict(site=name, dtype=dname, shape=[G, N, A, hid, D],
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
DRIVER_STEPS = 6  # steps or iterations before a run's boundary (cut from 20 for time)
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


_DRIVER_DATA = {}


def driver_data(model):
    """Phase 8's data set (``write_driver_dataset``, seed 0, with the test
    images' flip features), written once under build/data_* on the first
    call and read by phases 8, 10, 14 and 16; removed when the script
    exits. -> (argv of the data flags, GB of
    features, seconds this call spent writing it: 0 after the first)."""
    import atexit
    import tempfile

    if not _DRIVER_DATA:
        build = os.path.join(REPO, "build")
        os.makedirs(build, exist_ok=True)
        root = tempfile.mkdtemp(prefix="data_", dir=build)
        atexit.register(shutil.rmtree, root, ignore_errors=True)
        t0 = time.perf_counter()
        argv, gb = write_driver_dataset(root, model, flip_split="test")
        _DRIVER_DATA.update(argv=argv, gb=gb, seconds=time.perf_counter() - t0)
        return argv, gb, _DRIVER_DATA["seconds"]
    return _DRIVER_DATA["argv"], _DRIVER_DATA["gb"], 0.0


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
        from recurrent_fusion_network_torch.utils import profiling

        self.torch = torch
        self.copier = pinned.copier(DEVICE)
        self.copier.timing = True
        self.copier.timings = []
        copies = profiling.aggregate("pinned.copy")
        self.copies_before = copies.count if copies else 0  # the host's copy spans
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
        from recurrent_fusion_network_torch.utils import profiling

        events, self.copier.timings = self.copier.timings, []
        host_ms = [r.value * 1e3 for r in profiling.aggregate("pinned.copy").after(
            self.copies_before)]
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
    run's name. Every shape is then checked against the plain version.
    ``hid``: the attention width H of the model that runs (phase 17's is
    not the flagship's)."""

    def __init__(self, aa, hid=HID):
        self.aa, self.hid = aa, hid
        self.fwd, self.bwd = {}, {}  # shape -> {run: launches}

    def _count(self, table, shape, run, n=1):
        runs = table.setdefault(shape, {})
        runs[run] = runs.get(run, 0) + n

    def _shape(self, q, keys, v, values, mask, dw=None):
        if mask is not None or dw is not None or keys.shape[2] != self.hid:
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
    h = "" if recorder.hid == HID else f"_H{recorder.hid}"
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        fwd = [(f"drivers_G{G}_N{N}_A{A}_D{D}{h}", G, N, A, D, launches(runs))
               for (dt, G, N, A, D), runs in sorted(recorder.fwd.items()) if dt == dname]
        bwd = [(f"drivers_G{G}_N{N}_A{A}_D{D}{h}", G, N, A, D, need, launches(runs))
               for (dt, G, N, A, D, need), runs in sorted(recorder.bwd.items()) if dt == dname]
        if fwd:
            fwd_rows += check_attention_kernel(torch, aa, fwd, (dtype,), hid=recorder.hid)
        if bwd:
            bwd_rows += check_attention_backward(torch, aa, bwd, (dtype,), hid=recorder.hid)
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


METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE")


def check_stats(stats, what):
    bad = [k for k in METRICS if not (stats and k in stats and math.isfinite(stats[k]))]
    if bad:
        raise AssertionError(f"{what}: metrics {bad} missing or not finite in {stats}")
    return {k: stats[k] for k in METRICS}


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
    XE (bf16, 100 images x 5 captions, 7 steps, a boundary at iteration 6
    with beam-3 eval, the metrics and the triples), eval of the best triple
    on the test split, then SCST (f32, 51 images x 5) warm-started from it,
    7 iterations with a boundary at 12, under --rl_overlap 1 and 0. Launch
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

    data_argv, data_gb, data_s = driver_data(model)
    log(f"drivers: data set of {data_gb:.2f} GB of features (300 / 100 / 100 images, "
        f"{DRIVER_VOCAB} words) written in {data_s:.2f} s; {free_gb:.1f} GB were free")
    ck = os.path.join(root, "checkpoint")
    common = data_argv + ["--device", DEVICE, "--checkpoint_path", ck, "--eval_results_dir",
                          os.path.join(root, "eval_results"), "--val_images_use", "100",
                          "--beam_size", "3", "--language_eval", "1", "--seed", "0",
                          "--losses_log_every", "5"]
    out = {}

    # XE: steps 0..DRIVER_STEPS, the boundary at DRIVER_STEPS (one eval batch
    # of 100 images)
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

    # SCST from the XE best triple (iteration DRIVER_STEPS + 1 on):
    # DRIVER_STEPS + 1 iterations, the boundary at 2 DRIVER_STEPS (two eval
    # batches of 51 images)
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

FLEET_SEEDS = 2  # cut from 4 to make room for phase 15
FLEET_XE_EVERY = 5  # XE steps 0..5, the boundary at 5 (cut from 10 for time)
FLEET_RL_ITERS = 6  # SCST iterations 0..5 from the XE best triples, the boundary at 5
FLEET_FREE_GB = 60  # data set ~2 GB; per seed an XE triple, an rl_ triple and an rl_ best
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
    """A FLEET_SEEDS-member bf16 ensemble (seeded random members) on B = 512
    beam-3 batches through pipelined_map: captions/s beside phase 5's solo
    rate, the counters reading FLEET_SEEDS x 64 per batch."""
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
    XE fleet (main --n_seeds FLEET_SEEDS, bf16, 100 images x 5, steps 0..
    FLEET_XE_EVERY, the boundary at the last), the SCST fleet warm-started
    from its best triples (main_rl --n_seeds FLEET_SEEDS, f32, 51 images x
    5, FLEET_RL_ITERS iterations counted from 0, the boundary at the last), the
    ensemble CLI over the rl_ best triples (beam 3, bf16, the 100 test
    images) without, with and again without
    --eval_flip_ensemble 1, and a FLEET_SEEDS-member B = 512 ensemble's
    captions/s. Counters reset before and read after each run."""
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
    # phase 8's data set (written with the test images' flip features)
    data_argv, data_gb, _ = driver_data(model)
    mem_gb, free_gb = host_state()
    log(f"fleets: phase 8's data set ({data_gb:.2f} GB of features, with the test images' "
        f"flip features); {free_gb:.1f} GB free on disk, {mem_gb:.1f} GB of host memory "
        f"available")
    ck = os.path.join(root, "checkpoint")
    results = os.path.join(root, "eval_results")
    common = data_argv + ["--device", DEVICE, "--checkpoint_path", ck, "--eval_results_dir",
                          results, "--val_images_use", "100", "--beam_size", "3",
                          "--language_eval", "1", "--seed", "0", "--losses_log_every", "5",
                          "--n_seeds", str(S), "--id", "fleet"]
    out, reckon = {}, state_gb(model)

    # XE fleet: steps 0..FLEET_XE_EVERY, the boundary at the last, the
    # epilogue eval after it
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
                     reckoned_peak_gb_s8=xe["peak_gb"] + (8 - S) * reckon)
    mem_gb, free_gb = host_state()
    log(f"fleets XE: losses per seed {[[round(x, 3) for x in h] for h in losses]}; one seed's "
        f"f32 params and moments {reckon:.2f} GB, so S=8 would peak near (extrapolated "
        f"from S={S}) "
        f"{out['xe']['reckoned_peak_gb_s8']:.2f} GB; {free_gb:.1f} GB free on disk, "
        f"{mem_gb:.1f} GB of host memory available")

    # SCST fleet from the XE best triples, counted from 0 as the JAX fleet
    # counts a warm start: iterations 0..FLEET_RL_ITERS - 1, each logged,
    # the boundary at the last (two eval batches of 51 images), the
    # epilogue eval after it on the same params
    log_rl = os.path.join(root, "fleet_rl.jsonl")
    res, rl = run_driver(
        torch, main_rl_cli,
        common + ["--batch_size", "51", "--seq_per_img", "5", "--dtype", "float32",
                  "--start_from", ck, "--load_model_id", "fleet",
                  "--save_checkpoint_every", str(FLEET_RL_ITERS - 1),
                  "--max_iterations", str(FLEET_RL_ITERS), "--losses_log_every", "1",
                  "--json_log", log_rl, "--cider_df", os.path.join(root, "absent.p")],
        counters, (S * (130 * FLEET_RL_ITERS + 2 * 2 * per_eval), S * 65 * FLEET_RL_ITERS),
        "fleets SCST", recorder, "fleet_scst")
    rl_files = sorted(f for f in os.listdir(ck) if f.startswith("rl_"))
    # the mean rewards of this run's iterations, keyed 0.. (a warm start's
    # history holds nothing of the XE run's)
    rewards = [[h[i] for i in sorted(h)] for h in res["reward_histories"]]
    if [sorted(h) for h in res["reward_histories"]] != [list(range(FLEET_RL_ITERS))] * S:
        raise AssertionError(f"fleets SCST: reward histories {res['reward_histories']}, "
                             f"expected the keys 0..{FLEET_RL_ITERS - 1}")
    if rl_files != fleet_files("fleet", S, "rl_") or res["iter"] != FLEET_RL_ITERS \
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
REMAT_STEPS = 4  # per variant: the first (grads checked) and the second not timed (12, then 5)
REMAT_VARIANTS = (("off", False, "save_ctx", (65, 65)), ("off_again", False, "save_ctx", (65, 65)),
                  ("full", True, "full", (130, 65)), ("save_ctx", True, "save_ctx", (65, 65)))
OPTIMIZERS = {"rmsprop": dict(optim="rmsprop", optim_momentum=0.9),
              "adagrad": dict(optim="adagrad", optim_lr_decay=0.01),
              "adadelta": dict(optim="adadelta")}
OPTIM_STEPS = 3
FRONT_SHARD, FRONT_COMPARED = 64, 3  # shard rows; train batches compared and timed
FRONT_XE_EVERY, FRONT_RL_ITERS = 6, 6  # FRONT_XE_EVERY was 10 (cut for time)
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


# ---- phase 13: the asyncio front end, the greedy-baseline reward, the runbook

# keep-alive clients and the requests over them, two a connection, so each
# connection carries a second request (512, then 256, requests before)
AIO_CLIENTS, AIO_REQUESTS = 64, 128
AIO_DRAIN_S = 30  # the serve CLI's --drain_timeout in the SIGTERM check
SC_REPS = 5  # timed repeats of the greedy-baseline reward and its two parts
RUNBOOK_FREE_GB = 40  # two seeds' XE and rl_ flagship triples (5.4 GB each) and links
RUNBOOK_SEEDS = 2
RUNBOOK_TIMEOUT_S = 900
# the dry run's --max_iterations and --save_checkpoint_every (run_coco.sh),
# for the XE fleet and the SCST fleet alike: each runs 4 steps, the
# boundary at 2, the epilogue eval at 4
RUNBOOK_ITERS, RUNBOOK_EVERY = 4, 2
# the dry run, then the runbook resuming at its eval stage from the
# triples the first run wrote (its STAGES env)
RUNBOOK_RUNS = (("all", None), ("eval_again", "eval"))
RUNBOOK_STAGES = {"data.prepro_labels": "prepro", "data.prepro_ngrams": "prepro",
                  "data.feature_extraction.extract": "features", "main": "xe",
                  "main_rl": "rl", "eval": "eval", "eval_ensemble": "eval"}


class ChildLines:
    """A child's stdout read on a thread, so that every wait for it has a
    deadline."""

    def __init__(self, proc):
        import queue

        self.seen, self._q = [], queue.Queue()
        self._t = threading.Thread(target=self._read, args=(proc.stdout,), daemon=True)
        self._t.start()

    def _read(self, stream):
        for line in stream:
            self._q.put(line)
        self._q.put(None)

    def wait_for(self, text, timeout):
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._q.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(f"no line with {text!r} within {timeout} s:\n"
                                     + "".join(self.seen)[-3000:])
            self.seen.append(line)
            if text in line:
                return line

    def text(self, timeout=30):
        self._t.join(timeout)
        while not self._q.empty():
            line = self._q.get()
            if line is not None:
                self.seen.append(line)
        return "".join(self.seen)


def npz_body(fcs, atts):
    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **{f"fc_{i}": x for i, x in enumerate(fcs)},
             **{f"att_{i}": x for i, x in enumerate(atts)})
    return buf.getvalue()


def drive_http(port, bodies, clients):
    """``clients`` threads, each on its own keep-alive connection, post
    bodies i, i + clients, ... in turn. -> (replies, latencies in ms, wall s)."""
    import http.client

    n = len(bodies)
    replies, latency = [None] * n, [None] * n

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i in range(c, n, clients):
                t0 = time.perf_counter()
                conn.request("POST", "/caption", body=bodies[i],
                             headers={"Content-Type": "application/x-npz"})
                r = conn.getresponse()
                replies[i] = (r.status, json.loads(r.read()))
                latency[i] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # recorded, then judged by the caller
            replies[i] = (None, repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return replies, latency, time.perf_counter() - t0


def aio_serving(torch, model, params, card, counters, recorder):
    """Phase 13 (a): the flagship in bf16 behind the asyncio and then the
    threading front end (batch 16, beam 3): AIO_CLIENTS keep-alive clients
    send AIO_REQUESTS npz requests, the same to both; captions (one word per
    token) equal across the front ends and to the in-process decode of the
    same rows in batches of 16; 64 launches per decoded batch. Then the
    serve CLI with its default front end answers one request and drains on
    SIGTERM."""
    import numpy as np

    from recurrent_fusion_network_torch.decoding.aio_serve import run_server_async
    from recurrent_fusion_network_torch.decoding.http_serve import (
        CaptionService,
        feature_shapes,
        parse_features_payload,
        run_server,
    )
    from recurrent_fusion_network_torch.training.checkpoint import cast_tree

    vocab = {str(i + 1): f"w{i + 1}" for i in range(model.vocab_size)}
    svc = CaptionService(model, cast_tree(params, torch.bfloat16), vocab, device=DEVICE,
                         batch_size=SERVE_BATCH, beam_size=BEAM)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    fc_dims, att_shapes = feature_shapes(model)
    feats = ([torch.randn(AIO_REQUESTS, d, generator=gen, device=DEVICE).cpu().numpy()
              for d in fc_dims],
             [torch.randn(AIO_REQUESTS, a, d, generator=gen, device=DEVICE).cpu().numpy()
              for a, d in att_shapes])
    bodies = [npz_body([f[i] for f in feats[0]], [a[i] for a in feats[1]])
              for i in range(AIO_REQUESTS)]
    # the host's part of a request: parsing its body (the 3.15 MB npz)
    parse_ms = []
    for body in bodies[:32]:
        t0 = time.perf_counter()
        parse_features_payload(body, "application/x-npz")
        parse_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"body_mb": len(bodies[0]) / 1e6, "parse_ms": statistics.median(parse_ms)}
    try:
        svc.warmup()
        # the in-process decode of the same rows, cast as submit() casts them,
        # one batch at a time (each read back before the next)
        want = []
        t0 = time.perf_counter()
        with torch.inference_mode():
            for b in range(0, AIO_REQUESTS, SERVE_BATCH):
                rows = slice(b, b + SERVE_BATCH)
                dec = svc._decode(
                    [torch.from_numpy(f[rows]).to(DEVICE, torch.bfloat16) for f in feats[0]],
                    [torch.from_numpy(a[rows]).to(DEVICE, torch.bfloat16) for a in feats[1]])
                seq, lps = dec["seq"].cpu().numpy(), dec["seq_logprobs"].cpu().numpy()
                want += [svc.postprocess_row({"seq": seq[i], "seq_logprobs": lps[i]})
                         for i in range(seq.shape[0])]
        out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / (AIO_REQUESTS // SERVE_BATCH)
        log(f"aio serving: a request body {out['body_mb']:.2f} MB, parsed in "
            f"{out['parse_ms']:.2f} ms (median of 32); the in-process decode "
            f"{out['decode_ms']:.2f} ms per batch of {SERVE_BATCH} (serial, with readback) "
            f"on {card}")
        for frontend in ("asyncio", "threads"):
            if frontend == "asyncio":
                fe = run_server_async(svc, "127.0.0.1", 0)
                port, stop = fe.port, fe.stop
            else:
                httpd = run_server(svc, "127.0.0.1", 0)
                port = httpd.server_address[1]

                def stop():
                    httpd.shutdown()
                    httpd.server_close()
            before = dict(svc.server.stats)
            run = "aio_serve" if frontend == "asyncio" else "threads_serve"
            try:
                reset_counters(counters)
                with recorder.run(run):
                    replies, latency, wall = drive_http(port, bodies, AIO_CLIENTS)
                launches = read_counters(counters, f"{frontend} serving")
            finally:
                stop()
            stats = {k: svc.server.stats[k] - before[k] for k in before}
            bad = [r for r in replies if r is None or r[0] != 200]
            if bad:
                raise AssertionError(f"{frontend}: {len(bad)} bad replies, e.g. {bad[0]}")
            got = [r[1] for r in replies]
            differ = [i for i, (g, w) in enumerate(zip(got, want))
                      if g["caption"] != w["caption"]]
            if differ:
                raise AssertionError(f"{frontend}: {len(differ)} of {AIO_REQUESTS} captions "
                                     f"differ from the in-process decode, e.g. row {differ[0]}: "
                                     f"{got[differ[0]]} vs {want[differ[0]]}")
            lp_diff = max(abs(g["logprob"] - w["logprob"]) for g, w in zip(got, want))
            if stats["requests"] != AIO_REQUESTS or launches != (64 * stats["batches"], 0) \
                    or recorder.totals(run) != launches:
                raise AssertionError(f"{frontend}: launches {launches} (by shape "
                                     f"{recorder.totals(run)}) over {stats}, expected 64 a "
                                     f"batch")
            lat = sorted(latency)
            out[frontend] = dict(
                requests=AIO_REQUESTS, clients=AIO_CLIENTS, wall_s=wall,
                req_per_s=AIO_REQUESTS / wall, p50_ms=statistics.median(lat),
                p95_ms=statistics.quantiles(lat, n=20)[18], launches=launches,
                batches=stats["batches"], padded_rows=stats["padded_rows"],
                max_logprob_diff=lp_diff, stats=stats)
            log(f"aio serving {frontend}: {AIO_REQUESTS} npz requests from {AIO_CLIENTS} "
                f"keep-alive clients in {wall:.3f} s: {out[frontend]['req_per_s']:.1f} req/s, "
                f"p50 {out[frontend]['p50_ms']:.1f} ms, p95 {out[frontend]['p95_ms']:.1f} ms; "
                f"{stats['batches']} batches, {stats['padded_rows']} padded rows; captions "
                f"equal to the in-process decode (log-prob max diff {lp_diff:.3e}); launches "
                f"{launches} (64 a batch) on {card}")
    finally:
        svc.close()
    out["cli"] = serve_cli_drain(torch, model, params, bodies[0], want[0], card)
    return out


def serve_cli_drain(torch, model, params, body, want, card):
    """The serve CLI (default front end, bf16) over a flagship checkpoint:
    one request answered as the in-process decode answers it, then SIGTERM:
    exit 0 within --drain_timeout."""
    import http.client
    import tempfile

    from recurrent_fusion_network_torch.config import parse_opt
    from recurrent_fusion_network_torch.convert import params_to_jax
    from recurrent_fusion_network_torch.models import setup
    from recurrent_fusion_network_torch.training.checkpoint import save_checkpoint
    from recurrent_fusion_network_torch.training.train_loop import snapshot_opt

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="aio_cli_", dir=build)
    proc = None
    try:
        opt = parse_opt(["--caption_model", "recurrent_fusion_model", "--feature_type",
                         "feat_array", "--top_words_count", str(model.top_words_count)])
        opt.vocab_size, opt.seq_length = model.vocab_size, model.seq_length
        built = setup(opt)
        if (built.fc_feat_sizes, built.att_feat_sizes, built.att_nums) != (
                model.fc_feat_sizes, model.att_feat_sizes, model.att_nums):
            raise AssertionError("serve CLI: the registry's widths are not the flagship's")
        vocab = {str(i + 1): f"w{i + 1}" for i in range(model.vocab_size)}
        save_checkpoint(root, "aio", 0, params=params_to_jax(params),
                        infos={"opt": snapshot_opt(opt), "vocab": vocab}, best=True)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "recurrent_fusion_network_torch.serve", "--model_path",
             root, "--load_model_id", "aio", "--host", "127.0.0.1", "--port", "0",
             "--beam_size", str(BEAM), "--serve_batch_size", str(SERVE_BATCH),
             "--drain_timeout", str(AIO_DRAIN_S)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
        child = ChildLines(proc)
        ready = child.wait_for("caption service on", timeout=600)
        if "asyncio" not in ready:
            raise AssertionError(f"serve CLI: the default front end is not asyncio: {ready}")
        ready_s = time.perf_counter() - t0
        port = int(ready.split("caption service on ", 1)[1].split()[0].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = json.loads(r.read())
        conn.request("POST", "/caption", body=body, headers={"Content-Type": "application/x-npz"})
        r = conn.getresponse()
        reply = (r.status, json.loads(r.read()))
        conn.close()
        if health.get("frontend") != "asyncio" or reply[0] != 200 \
                or reply[1]["caption"] != want["caption"]:
            raise AssertionError(f"serve CLI: healthz {health}, reply {reply}, want {want}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=AIO_DRAIN_S + 30)
        drain_s = time.perf_counter() - t1
        text = child.text()
        if rc != 0 or "shutdown complete" not in text or drain_s > AIO_DRAIN_S:
            raise AssertionError(f"serve CLI: exit {rc} after SIGTERM in {drain_s:.2f} s:\n"
                                 f"{text[-3000:]}")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    log(f"aio serving CLI: default front end asyncio, ready in {ready_s:.2f} s, one request "
        f"answered as in process, SIGTERM -> exit 0 in {drain_s:.3f} s (--drain_timeout "
        f"{AIO_DRAIN_S}) on {card}")
    return dict(ready_s=ready_s, drain_s=drain_s, exit=rc)


def greedy_launches(model):
    """Forward launches of one greedy rollout of the flagship: every
    stage-I encoder per stage-I review step, stage II per step, and the
    decoder per step (seq_length + 1)."""
    return (model.num_review_steps_0 * len(model.att_nums) + model.num_review_steps
            + model.seq_length + 1)


def sc_reward_phase(torch, model, params, scorer, card, counters, recorder):
    """Phase 13 (b): get_self_critical_reward at phase 7's SCST shape (f32,
    B = RL_ROWS, 5 references an image): the rewards equal compute_reward over
    model_sample's greedy tokens; launches one greedy rollout's; the rollout's
    and the reward's ms."""
    import numpy as np

    from recurrent_fusion_network_torch.decoding.api import model_sample
    from recurrent_fusion_network_torch.rewards.self_critical import (
        compute_reward,
        get_self_critical_reward,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(14)
    fcs, atts = features(torch, model, RL_ROWS, gen, torch.float32)
    rng = np.random.default_rng(14)
    L, V = model.seq_length, model.vocab_size
    sampled = rng.integers(1, V + 1, (RL_ROWS, L))
    for r, n in enumerate(rng.integers(3, L + 1, RL_ROWS)):
        sampled[r, n:] = 0
    gts = [rng.integers(1, V + 1, (5, L)) for _ in range(RL_ROWS)]
    get_self_critical_reward(model, params, fcs, atts, gts, sampled, scorer)  # warm
    torch.cuda.synchronize()
    reset_counters(counters)
    t0 = time.perf_counter()
    with recorder.run("sc_reward"):
        rewards = get_self_critical_reward(model, params, fcs, atts, gts, sampled, scorer)
    times = {"total": [(time.perf_counter() - t0) * 1e3], "rollout": [], "reward": []}
    launches = read_counters(counters, "sc_reward")
    expect = (greedy_launches(model), 0)
    if launches != expect or recorder.totals("sc_reward") != expect:
        raise AssertionError(f"sc_reward: launches {launches}, expected {expect}")
    for _ in range(SC_REPS):
        t0 = time.perf_counter()
        with torch.inference_mode():
            greedy = model_sample(model, params, fcs, atts, beam_size=1,
                                  sample_max=True).seq.cpu()
        t1 = time.perf_counter()
        want = compute_reward(scorer, sampled, greedy.numpy(), gts)
        t2 = time.perf_counter()
        get_self_critical_reward(model, params, fcs, atts, gts, sampled, scorer)
        times["rollout"].append((t1 - t0) * 1e3)
        times["reward"].append((t2 - t1) * 1e3)
        times["total"].append((time.perf_counter() - t2) * 1e3)
    total_ms, rollout_ms, reward_ms = (statistics.median(times[k])
                                       for k in ("total", "rollout", "reward"))
    if not np.array_equal(rewards, want) or not np.isfinite(rewards).all():
        raise AssertionError("sc_reward: the rewards differ from compute_reward over "
                             "model_sample's greedy tokens")
    out = dict(rows=RL_ROWS, launches=launches, total_ms=total_ms, rollout_ms=rollout_ms,
               reward_ms=reward_ms, mean_reward=float(rewards[:, 0].mean()),
               greedy_rows_nonempty=int((greedy[:, 0] > 0).sum()))
    log(f"sc_reward: get_self_critical_reward f32 B={RL_ROWS}: {total_ms:.2f} ms (greedy "
        f"rollout {rollout_ms:.2f} ms, CIDEr-D reward {reward_ms:.2f} ms; medians of "
        f"{SC_REPS + 1}, {SC_REPS}, {SC_REPS}; engine "
        f"{scorer.engine}), rewards equal compute_reward over model_sample's greedy tokens, "
        f"launches {launches} on {card}")
    return out


PROBE_THEN = "--and-then"  # separates the launch probe's commands


def launch_probe(log_path, argv):
    """``chip_smoke.py --launch-probe LOG -m MODULE ARGS [--and-then -m
    MODULE ARGS ...]``: run each MODULE in turn in this process as ``python
    -m`` does, with both kernels' launches counted by shape, and append for
    each its launches, the seconds and the exit to LOG as one JSON line
    (the counters reset before each). Any other command line (the
    runbook's heredoc) runs the interpreter itself."""
    if argv[:1] != ["-m"]:
        os.execv(sys.executable, [sys.executable] + argv)
    import runpy

    sys.path.insert(0, REPO)
    from recurrent_fusion_network_torch.kernels import additive_attention as aa

    commands = [[]]
    for arg in argv:
        if arg == PROBE_THEN:
            commands.append([])
        else:
            commands[-1].append(arg)
    for command in commands:
        module, recorder, ok = command[1], ShapeRecorder(aa), False
        reset_counters([aa])
        t0 = time.perf_counter()
        try:
            sys.argv = [module] + command[2:]
            with recorder.run("run"):
                runpy.run_module(module, run_name="__main__", alter_sys=True)
            ok = True
        finally:
            with open(log_path, "a") as f:
                f.write(json.dumps({
                    "module": module, "argv": command[2:], "ok": ok,
                    "seconds": time.perf_counter() - t0,
                    "launches": [aa.launches, aa.bwd_launches],
                    "scalar": aa.scalar_launches,
                    "fwd": [[list(k), v["run"]] for k, v in recorder.fwd.items()],
                    "bwd": [[list(k), v["run"]] for k, v in recorder.bwd.items()]}) + "\n")


# the runbook's interpreter: a client that hands its command, environment,
# directory and stdin / stdout / stderr to the probe server and exits with
# the status of the process the server forked for it
PROBE_CLIENT = """#!{python}
import json, os, socket, sys
s = socket.socket(socket.AF_UNIX)
s.connect({sock!r})
socket.send_fds(s, [b"c"], [0, 1, 2])
s.sendall(json.dumps({{"argv": sys.argv[1:], "env": dict(os.environ),
                      "cwd": os.getcwd()}}).encode())
s.shutdown(socket.SHUT_WR)
reply = b""
while True:
    chunk = s.recv(64)
    if not chunk:
        break
    reply += chunk
code = int(reply)
sys.exit(code if code >= 0 else 128 - code)
"""


def probe_server(sock_path, log_path):
    """``chip_smoke.py --probe-server SOCK LOG``: the runbook's stage
    processes, each forked from this one once torch (with its compiler
    stack) and the kernels' module are imported (CUDA untouched, no thread
    started), so a stage pays neither the interpreter's start nor torch's
    import; each child then runs
    ``launch_probe(LOG, ...)`` on the client's command, environment,
    directory and standard streams (``PROBE_CLIENT``) and exits as a
    process does (threads joined, atexit run). One client at a time (the
    runbook's stages run one after another); the status goes back to the
    client. Returns only in a child, its exit code."""
    import socket

    sys.path.insert(0, REPO)
    import torch  # noqa: F401 -- imported once, before the forks
    # torch's compiler stack, which a stage would import itself on its first
    # decomposed op (the backbones' shapes on the meta device): about 2 s
    import torch._dynamo  # noqa: F401

    from recurrent_fusion_network_torch.kernels import additive_attention  # noqa: F401

    srv = socket.socket(socket.AF_UNIX)
    srv.bind(sock_path)
    srv.listen(4)
    while True:
        conn, _ = srv.accept()
        with conn:
            _, fds, _, _ = socket.recv_fds(conn, 1, 3)
            body = b""
            while True:
                chunk = conn.recv(1 << 16)
                if not chunk:
                    break
                body += chunk
            req = json.loads(body)
            pid = os.fork()
            if pid == 0:
                srv.close()
                conn.close()
                for target, fd in enumerate(fds):
                    os.dup2(fd, target)
                    os.close(fd)
                os.chdir(req["cwd"])
                os.environ.clear()
                os.environ.update(req["env"])
                try:
                    launch_probe(log_path, req["argv"])
                except SystemExit as e:
                    if e.code is None or isinstance(e.code, int):
                        return e.code or 0
                    print(e.code, file=sys.stderr)
                    return 1
                return 0
            for fd in fds:
                os.close(fd)
            _, status = os.waitpid(pid, 0)
            conn.sendall(str(os.waitstatus_to_exitcode(status)).encode())


def eval_metrics(path, what):
    import re

    with open(path) as f:
        text = f.read()
    stats = {k: float(v) for k, v in re.findall(r"^(\w+): (\S+)$", text, re.M)
             if k in METRICS}
    return check_stats(stats, what)


def runbook_phase(torch, card, recorder):
    """Phase 13 (c): DRY_RUN=1 bash recurrent_fusion_network_torch/scripts/
    run_coco.sh (NUM_SEEDS 2, DATA_DIR under build/, a unique ID), every
    stage through the port's CLIs on the card, each run under the launch
    probe; then STAGES=eval again (``RUNBOOK_RUNS``). Ranks 0 and 1 hold
    their XE and rl_ triples, both eval logs finite metrics; the SCST fleet
    counts from 0 as the JAX fleet does: as many steps as the XE fleet
    (RUNBOOK_ITERS), its rolling rl_ triples from the boundary at
    RUNBOOK_EVERY with this run's rewards only; every launch's
    shape goes to ``recorder`` under runbook_<stage>[_again]. The run's
    checkpoint/ and log/ files are deleted."""
    import glob
    import tempfile

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    free_gb = shutil.disk_usage(build).free / 1e9
    if free_gb < RUNBOOK_FREE_GB:
        raise AssertionError(f"runbook: {free_gb:.1f} GB free under {build}, "
                             f"{RUNBOOK_FREE_GB} GB needed")
    root = tempfile.mkdtemp(prefix="runbook_", dir=build)
    run_id = f"chipsmoke{os.getpid()}"
    probe_log = os.path.join(root, "launches.jsonl")
    sock = os.path.join(root, "probe.sock")
    python = os.path.join(root, "python")
    with open(python, "w") as f:
        f.write(PROBE_CLIENT.format(python=sys.executable, sock=sock))
    os.chmod(python, 0o755)
    server_err = os.path.join(root, "probe_server.err")
    with open(server_err, "w") as err:
        server = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--probe-server", sock, probe_log],
                                  start_new_session=True, stdout=err, stderr=err)
    deadline = time.perf_counter() + 120
    while not os.path.exists(sock):
        if server.poll() is not None or time.perf_counter() > deadline:
            server.kill()
            with open(server_err) as f:
                raise AssertionError(f"runbook: the probe server did not start (exit "
                                     f"{server.poll()}): {f.read()[-3000:]}")
        time.sleep(0.1)
    env = dict(os.environ, DRY_RUN="1", DATA_DIR=os.path.join(root, "data"), ID=run_id,
               NUM_SEEDS=str(RUNBOOK_SEEDS), PYTHON=python, PYTHONUNBUFFERED="1")
    script = os.path.join(REPO, "recurrent_fusion_network_torch", "scripts", "run_coco.sh")
    ck, logs = os.path.join(REPO, "checkpoint"), os.path.join(REPO, "log")
    out = {}
    try:
        for run, stages in RUNBOOK_RUNS:
            with open(probe_log, "w"):
                pass
            t0 = time.perf_counter()
            r = subprocess.run(["bash", script], env=dict(env, **({"STAGES": stages}
                                                                  if stages else {})),
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                               timeout=RUNBOOK_TIMEOUT_S)
            wall = time.perf_counter() - t0
            with open(probe_log) as f:
                calls = [json.loads(line) for line in f]
            if r.returncode != 0 or "all requested stages" not in r.stdout \
                    or not all(c["ok"] for c in calls):
                raise AssertionError(f"runbook {run}: exit {r.returncode}:\n{r.stdout[-4000:]}")
            seconds, launches = {}, {}
            for c in calls:
                stage = RUNBOOK_STAGES[c["module"].split(".", 1)[1]]
                seconds[stage] = seconds.get(stage, 0.0) + c["seconds"]
                name = f"runbook_{stage}" if run == "all" else f"runbook_{stage}_again"
                if c["scalar"]:
                    raise AssertionError(f"runbook: {c['module']} took the scalar path")
                by_shape = [sum(n for _, n in c["fwd"]), sum(n for _, n in c["bwd"])]
                if by_shape != c["launches"]:
                    raise AssertionError(f"runbook: {c['module']} launches {c['launches']} "
                                         f"but {by_shape} by shape")
                for table, rows in ((recorder.fwd, c["fwd"]), (recorder.bwd, c["bwd"])):
                    for shape, n in rows:
                        recorder._count(table, tuple(shape), name, n)
                launches[name] = [a + b for a, b in zip(launches.get(name, [0, 0]),
                                                        c["launches"])]
            expect = {"all": ["prepro", "prepro"] + ["features"] * 5 + ["xe", "rl", "eval",
                                                                          "eval"],
                      "eval_again": ["eval", "eval"]}[run]
            if [RUNBOOK_STAGES[c["module"].split(".", 1)[1]] for c in calls] != expect:
                raise AssertionError(f"runbook {run}: commands {[c['module'] for c in calls]}")
            metrics = {k: eval_metrics(os.path.join(logs, f"eval_{k}_{run_id}"),
                                       f"runbook {run} eval {k}")
                       for k in ("single", "ensemble")}
            if run == "all":
                missing = [f for rank in range(RUNBOOK_SEEDS) for prefix in ("", "rl_")
                           for kind in ("model", "optimizer", "infos")
                           for f in (f"{prefix}{kind}_{run_id}_{rank}-best.pkl",)
                           if not os.path.exists(os.path.join(ck, f))]
                if missing:
                    raise AssertionError(f"runbook: triples missing: {missing}")
                out["rl_infos"] = runbook_rl_infos(ck, run_id, launches)
            out[run] = dict(wall_s=wall, seconds=seconds, launches=launches, metrics=metrics)
            log(f"runbook {run}: exit 0 in {wall:.2f} s; seconds by stage "
                + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
                + f"; launches (fwd, bwd) {launches}; eval metrics single "
                f"{metrics['single']}, ensemble {metrics['ensemble']} on {card}")
        out["free_gb"] = free_gb
    finally:
        os.killpg(server.pid, signal.SIGKILL)  # the server and any child left
        server.wait()
        for path in glob.glob(os.path.join(ck, f"*{run_id}*")) + glob.glob(
                os.path.join(logs, f"*{run_id}*")):
            os.remove(path)
        shutil.rmtree(root, ignore_errors=True)
    return out


def runbook_rl_infos(ck, run_id, launches):
    """The runbook's SCST fleet counted its warm start from 0: as many
    backward launches as the XE fleet (RUNBOOK_ITERS steps of each seed),
    each seed's rolling rl_ triple written at the boundary at RUNBOOK_EVERY
    (iter RUNBOOK_EVERY + 1, rewards 0..RUNBOOK_EVERY), its rl_-best there
    or at the epilogue (iter RUNBOOK_ITERS). -> {rank: (rolling iter, best
    iter)}."""
    from recurrent_fusion_network_torch.training.checkpoint import load_infos

    bwd = RUNBOOK_SEEDS * RUNBOOK_ITERS * 65
    if launches["runbook_rl"][1] != bwd or launches["runbook_xe"][1] != bwd:
        raise AssertionError(f"runbook: backward launches XE {launches['runbook_xe'][1]}, "
                             f"SCST {launches['runbook_rl'][1]}, expected {bwd} each")
    iters = {}
    for rank in range(RUNBOOK_SEEDS):
        rolling = load_infos(ck, run_id, rank, best=False, prefix="rl_")
        best = load_infos(ck, run_id, rank, best=True, prefix="rl_")
        iters[rank] = (rolling.get("iter"), best.get("iter"))
        rewards = sorted(rolling.get("loss_history", {}))
        if iters[rank][0] != RUNBOOK_EVERY + 1 \
                or iters[rank][1] not in (RUNBOOK_EVERY + 1, RUNBOOK_ITERS) \
                or rewards != list(range(RUNBOOK_EVERY + 1)):
            raise AssertionError(f"runbook: seed {rank}'s rl_ triples: iter (rolling, best) "
                                 f"{iters[rank]}, rewards at {rewards}")
    log(f"runbook: the SCST fleet ran {RUNBOOK_ITERS} iterations a seed from 0; rl_ triples' "
        f"iter (rolling, best) by seed {iters}")
    return iters


def phase13(torch, aa, model, card, scorer):
    """Phase 13: (a) the asyncio front end, (b) the greedy-baseline reward,
    (c) the runbook's dry run. -> (results, forward rows, backward rows),
    the rows of every shape the three met, checked against the plain
    versions."""
    t0 = time.perf_counter()
    recorder = ShapeRecorder(aa)
    params = model.init_params(torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    out = {"serve": aio_serving(torch, model, params, card, [aa], recorder)}
    out["sc_reward"] = sc_reward_phase(torch, model, params, scorer, card, [aa], recorder)
    del params
    torch.cuda.empty_cache()
    out["runbook"] = runbook_phase(torch, card, recorder)
    runs = {"aio_serve": ("aio_serve",), "threads_serve": ("threads_serve",),
            "sc_reward": ("sc_reward",)}
    for run, _ in RUNBOOK_RUNS:
        for name in out["runbook"][run]["launches"]:
            runs[name] = (name,)
    fwd_rows, bwd_rows = check_driver_sites(torch, aa, recorder, runs)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 13 in {out['seconds']:.2f} s: {len(recorder.fwd)} forward and "
        f"{len(recorder.bwd)} backward shapes checked against the plain versions")
    return out, fwd_rows, bwd_rows


# ------------------------------------------- 14. SPICE rewards, orbax, trace

SPICE_ITERS = 4  # SCST iterations per SPICE back end (phase 7's batch; was 10)
SPICE_FLEET_ITERS = 2  # the S = 2 SCST fleet's iterations with SPICE (was 3)
# XE steps 0..10, boundaries at 5 and 10 (were 10, 21), for the DCP runs;
# 0..6 for the pickle run (cut from 0..10); the resumed run's 5 steps give
# DriverProbe its two steady gaps
ORBAX_EVERY, ORBAX_STEPS = 5, 11
ORBAX_FREE_GB = 25  # data set ~1.6 GB; at most three 5.4 GB flagship triples at a time
TRACE_STEPS, TRACE_START, TRACE_LEN = 6, 3, 2  # --max_iterations, --profile_start, _steps
KERNEL_NAMES = {"additive_attention_fwd": "additive_attention_fwd_kernel",
                "additive_attention_bwd": "additive_attention_bwd_rows"}
TRACE_KERNEL_CAT = "kernel"  # the Chrome trace's category of device kernels


def spice_vocab(model):
    """Caption words for the model's ids, so the approximate SPICE parser
    finds objects, attributes and relations in the rollouts."""
    return {str(i): CAPTION_WORDS[i % len(CAPTION_WORDS)] for i in range(1, model.vocab_size + 1)}


def spice_loader(model, vocab):
    loader = FixedBatchLoader(model, RL_ROWS, 14)
    loader.get_vocab = lambda: vocab
    return loader


def train_spice(torch, model, scorer, card, counters, recorder, backend, port):
    """Phase 7's SCST (f32, B = RL_ROWS, 5 references a row, the native
    CIDEr-D engine) through train_rl() with --spice_weight 1 --cider_weight
    1 on the ``backend``: the counters reset just before and read just
    after (130 + 65 launches an iteration), one SPICE hook for the run,
    finite losses and rewards; the steady iteration ms and, per
    iteration, the reward's ms split into SPICE and the rest (CIDEr-D).
    -> (summary, [(sampled ids, greedy ids, rewards)] per iteration)."""
    from unittest import mock

    import numpy as np

    from recurrent_fusion_network_torch.training import train_rl_loop as rl

    vocab = spice_vocab(model)
    loader = spice_loader(model, vocab)
    opt = train_opts(model, rl_overlap=1, spice_weight=1.0, cider_weight=1.0,
                     spice_backend=backend, ip="127.0.0.1", port=port)
    real = rl.compute_reward
    calls, hooks, reward_s, spice_s, spice_mean, stamps = [], [], [], [], [], []

    def reward_spy(scorer_, gen, greedy, gts, **kw):
        hook = kw["spice_fn"]
        hooks.append(hook)

        def timed(hyps, refs):
            t = time.perf_counter()
            scores = hook(hyps, refs)
            spice_s.append(time.perf_counter() - t)
            spice_mean.append(float(np.mean(scores[:len(gen)])))  # the sampled rows'
            return scores

        t = time.perf_counter()
        out = real(scorer_, gen, greedy, gts, **{**kw, "spice_fn": timed})
        reward_s.append(time.perf_counter() - t)
        calls.append((gen.copy(), greedy.copy(), out))
        return out

    def log_fn(line):
        stamps.append(time.perf_counter())
        log(f"spice {backend}: {line}")

    run = f"spice_{backend}"
    torch.cuda.synchronize()
    reset_counters(counters)  # main path starts here
    t0 = time.perf_counter()
    with mock.patch.object(rl, "compute_reward", reward_spy), recorder.run(run):
        infos = rl.train_rl(opt, loader, scorer, max_iterations=SPICE_ITERS, log_fn=log_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters, run)
    expect = (130 * SPICE_ITERS, 65 * SPICE_ITERS)
    if launches != expect or recorder.totals(run) != expect:
        raise AssertionError(f"{run}: launches {launches}, by shape {recorder.totals(run)}, "
                             f"expected {expect}")
    losses = [infos["train_loss_history"][i] for i in range(SPICE_ITERS)]
    rewards = [infos["loss_history"][i] for i in range(SPICE_ITERS)]
    if not all(map(math.isfinite, losses + rewards)):
        raise AssertionError(f"{run}: losses {losses} or rewards {rewards} not finite")
    if len(hooks) != SPICE_ITERS or any(h is not hooks[0] for h in hooks) \
            or len(spice_s) != SPICE_ITERS:
        raise AssertionError(f"{run}: {len(hooks)} reward calls, {len(spice_s)} SPICE calls, "
                             f"{len({id(h) for h in hooks})} hooks")
    steady = [b - a for a, b in zip(stamps[2:], stamps[3:])]
    iter_ms = (stamps[-1] - stamps[2]) / len(steady) * 1e3
    med = lambda xs: statistics.median(xs[1:]) * 1e3  # noqa: E731
    out = dict(launches=launches, iter_ms=iter_ms, reward_ms=med(reward_s),
               spice_ms=med(spice_s),
               cider_ms=statistics.median([a - b for a, b in zip(reward_s[1:], spice_s[1:])])
               * 1e3, losses=losses, rewards=rewards, wall_s=wall, spice_means=spice_mean)
    log(f"spice {backend}: f32 B={RL_ROWS} rl_overlap=1, --spice_weight 1 --cider_weight 1: "
        f"{SPICE_ITERS} iterations through train_rl() in {wall:.3f} s; steady iteration "
        f"{iter_ms:.2f} ms; reward per iteration (medians past the first) {out['reward_ms']:.2f} "
        f"ms, of which SPICE {out['spice_ms']:.2f} ms over 2 x {RL_ROWS} hypotheses x 5 "
        f"references and CIDEr-D {out['cider_ms']:.2f} ms; mean SPICE of the sampled rows "
        f"{[round(m, 4) for m in spice_mean]}; mean rewards {rewards}; losses {losses}; "
        f"launches {launches} on {card}")
    return out, calls


def spice_rewards(torch, model, scorer, card, counters, recorder):
    """Phase 14 (a): SCST with SPICE through the approx back end and through
    the http back end against this package's service (metrics.spice_server,
    in-process, an ephemeral loopback port); the http run's rewards equal
    the approx scorer's on the same rollouts; then the S = 2 SCST fleet
    with the approx back end."""
    from unittest import mock

    import numpy as np

    from recurrent_fusion_network_torch.metrics.spice import make_spice_fn
    from recurrent_fusion_network_torch.metrics.spice_server import run_spice_server
    from recurrent_fusion_network_torch.rewards.self_critical import compute_reward
    from recurrent_fusion_network_torch.training import multi_seed

    out = {}
    out["approx"], _ = train_spice(torch, model, scorer, card, counters, recorder, "approx", 0)
    torch.cuda.empty_cache()
    httpd = run_spice_server("127.0.0.1", 0)
    try:
        out["http"], calls = train_spice(torch, model, scorer, card, counters, recorder,
                                         "http", httpd.server_address[1])
    finally:
        httpd.shutdown()
        httpd.server_close()
    torch.cuda.empty_cache()
    approx_fn = make_spice_fn(train_opts(model, spice_backend="approx"), spice_vocab(model))
    gts = FixedBatchLoader(model, RL_ROWS, 14).batch["gts"]
    for k, (gen, greedy, rewards) in enumerate(calls):
        want = compute_reward(scorer, gen, greedy, gts, cider_weight=1.0, spice_weight=1.0,
                              spice_fn=approx_fn)
        if not np.array_equal(rewards, want):
            raise AssertionError(f"spice: iteration {k}'s http rewards differ from the approx "
                                 f"scorer's by {np.abs(rewards - want).max()}")
    out["http_equals_approx"] = len(calls)
    log(f"spice: the http back end's rewards equal the approx scorer's on the same rollouts "
        f"in all {len(calls)} iterations; the http file handoff adds "
        f"{out['http']['spice_ms'] - out['approx']['spice_ms']:.2f} ms per iteration's SPICE "
        f"on {card}")

    # the S = 2 SCST fleet, one SPICE hook for both seeds
    vocab = spice_vocab(model)
    loader = spice_loader(model, vocab)
    opt = train_opts(model, spice_weight=1.0, cider_weight=1.0, spice_backend="approx")
    hooks = []
    real = multi_seed.compute_reward

    def reward_spy(*a, **kw):
        hooks.append(kw["spice_fn"])
        return real(*a, **kw)

    torch.cuda.synchronize()
    reset_counters(counters)  # main path starts here
    t0 = time.perf_counter()
    with mock.patch.object(multi_seed, "compute_reward", reward_spy), \
            recorder.run("spice_fleet"):
        fleet = multi_seed.train_multi_seed_rl(opt, loader, scorer, 2,
                                               max_iterations=SPICE_FLEET_ITERS,
                                               eval_at_end=False, save=False,
                                               log_fn=lambda line: log(f"spice fleet: {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters, "spice fleet")
    expect = (2 * 130 * SPICE_FLEET_ITERS, 2 * 65 * SPICE_FLEET_ITERS)
    losses = [v for h in fleet["train_loss_histories"] for v in h.values()]
    if launches != expect or recorder.totals("spice_fleet") != expect:
        raise AssertionError(f"spice fleet: launches {launches}, by shape "
                             f"{recorder.totals('spice_fleet')}, expected {expect}")
    if len(losses) != 2 * SPICE_FLEET_ITERS or not all(map(math.isfinite, losses)) \
            or len(hooks) != 2 * SPICE_FLEET_ITERS or any(h is not hooks[0] for h in hooks):
        raise AssertionError(f"spice fleet: losses {losses}, {len(hooks)} reward calls")
    del fleet
    out["fleet"] = dict(launches=launches, wall_s=wall, losses=losses)
    log(f"spice fleet: S = 2, {SPICE_FLEET_ITERS} iterations with the approx back end in "
        f"{wall:.2f} s; losses {losses}; launches {launches} on {card}")
    return out


def dir_bytes(path):
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def checkpoint_files(ck):
    """{name: bytes} of a checkpoint directory's triples (files and DCP
    directories)."""
    return {name: dir_bytes(os.path.join(ck, name)) for name in sorted(os.listdir(ck))}


class SaveTimer:
    """Times every save_checkpoint of a run (pickle, DCP sync or DCP async):
    the seconds until it returns and, for an async one, until its write is
    done (the DCP futures' completion); with ``snapshot``, the rolling
    triple of the first boundary is hard-linked into that directory."""

    def __init__(self, snapshot=None):
        self.saves, self.snapshot = [], snapshot

    @contextlib.contextmanager
    def patch(self, run_id):
        from unittest import mock

        from recurrent_fusion_network_torch.training import checkpoint, orbax_ckpt

        real_async = orbax_ckpt.dcp.async_save

        def async_save(*a, **kw):
            future = real_async(*a, **kw)
            entry = self.saves[-1]
            entry["futures"] += 1
            future.add_done_callback(lambda _f: entry["done"].append(time.perf_counter()))
            return future

        def timed(real):
            def save(*a, **kw):
                entry = dict(start=time.perf_counter(), best=kw.get("best", False), futures=0,
                             done=[], iter=(kw.get("infos") or {}).get("iter"))
                self.saves.append(entry)
                real(*a, **kw)
                entry["returned"] = time.perf_counter()
                if self.snapshot and not entry["best"] and len(self.saves) == 1:
                    orbax_ckpt.link_triple(a[0], run_id, 0, self.snapshot, run_id,
                                           src_best=False, dst_best=False)
            return save

        with mock.patch.object(checkpoint, "save_checkpoint", timed(checkpoint.save_checkpoint)), \
                mock.patch.object(orbax_ckpt, "save_checkpoint",
                                  timed(orbax_ckpt.save_checkpoint)), \
                mock.patch.object(orbax_ckpt.dcp, "async_save", async_save):
            yield

    def summary(self):
        out = []
        for e in self.saves:
            done = max(e["done"]) if e["done"] else e["returned"]
            out.append(dict(iter=e["iter"], best=e["best"],
                            returned_s=e["returned"] - e["start"], done_s=done - e["start"]))
        return out


def boundary_gaps(run, every, steps):
    """The fetch gaps (ms) that hold a boundary: the gap into fetch k + 1
    holds iteration k's boundary."""
    gaps = run["fetch_gaps_ms"]
    return [gaps[k] for k in range(every, steps, every) if k < len(gaps)]


def orbax_checkpoints(torch, model, card, counters, recorder):
    """Phase 14 (b) and (c) on phase 8's data set, their files under
    build/orbax_* (deleted when done)."""
    import tempfile

    from recurrent_fusion_network_torch import eval as eval_cli
    from recurrent_fusion_network_torch import eval_ensemble as ens_cli
    from recurrent_fusion_network_torch import main as main_cli

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    free_gb = shutil.disk_usage(build).free / 1e9
    if free_gb < ORBAX_FREE_GB:
        raise AssertionError(f"orbax: {free_gb:.1f} GB free under {build}, "
                             f"{ORBAX_FREE_GB} GB needed")
    root = tempfile.mkdtemp(prefix="orbax_", dir=build)
    try:
        return _orbax_checkpoints(torch, model, card, counters, recorder, root, main_cli,
                                  eval_cli, ens_cli, free_gb)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _orbax_checkpoints(torch, model, card, counters, recorder, root, main_cli, eval_cli,
                       ens_cli, free_gb):
    data_argv, data_gb, _ = driver_data(model)
    log(f"orbax: phase 8's data set ({data_gb:.2f} GB); {free_gb:.1f} GB were free")
    per_eval = 65 + 64
    common = data_argv + ["--device", DEVICE, "--eval_results_dir",
                          os.path.join(root, "eval_results"), "--val_images_use", "100",
                          "--beam_size", "3", "--language_eval", "1", "--seed", "0",
                          "--losses_log_every", "1", "--dtype", "bfloat16", "--batch_size",
                          "100", "--seq_per_img", "5", "--id", "ox"]
    xe = common + ["--save_checkpoint_every", str(ORBAX_EVERY)]
    modes = {"pickle": ["--checkpoint_backend", "pickle"],
             "dcp_sync": ["--checkpoint_backend", "orbax", "--checkpoint_async", "0"],
             "dcp_async": ["--checkpoint_backend", "orbax", "--checkpoint_async", "1"]}
    out, losses = {}, {}
    snap = os.path.join(root, "snapshot")
    for mode, flags in modes.items():
        # the DCP runs to ORBAX_STEPS (two boundaries: the resume follows
        # the sync run, and the async run's second save waits for the first
        # one's write in flight); the pickle run one step past the first
        # boundary, whose fetch gap is its stall (cut for time)
        steps = ORBAX_EVERY + 2 if mode == "pickle" else ORBAX_STEPS
        n_bounds = (steps - 1) // ORBAX_EVERY
        expect = (65 * steps + per_eval * n_bounds, 65 * steps)
        ck = os.path.join(root, mode)
        log_path = os.path.join(root, f"{mode}.jsonl")
        timer = SaveTimer(snap if mode == "dcp_sync" else None)
        with timer.patch("ox"):
            infos, run = run_driver(
                torch, main_cli, xe + flags + ["--checkpoint_path", ck, "--max_iterations",
                                               str(steps), "--json_log", log_path],
                counters, expect, f"orbax {mode}", recorder, f"orbax_{mode}")
        losses[mode] = infos["loss_history"]
        if not all(math.isfinite(losses[mode][i]) for i in range(steps)):
            raise AssertionError(f"orbax {mode}: losses {losses[mode]}")
        del infos
        vals = jsonl(log_path, "val")
        files = checkpoint_files(ck)
        suffix = ".pkl" if mode == "pickle" else ".orbax"
        rolling = [f"{k}_ox_0{suffix}" for k in ("model", "optimizer")] + ["infos_ox_0.pkl"]
        if not set(rolling) <= set(files) or not any("-best" in f for f in files):
            raise AssertionError(f"orbax {mode}: files {sorted(files)}")
        saves = timer.summary()
        futures = 2 if mode == "dcp_async" else 0  # model and optimizer, in the background
        if len(saves) != n_bounds or any(e["futures"] != futures for e in timer.saves):
            raise AssertionError(f"orbax {mode}: saves {timer.saves}")
        run.update(files=files, triple_bytes=sum(files[f] for f in rolling), saves=saves,
                   eval_s=[v["seconds"] for v in vals],
                   boundary_save_s=[v["save_seconds"] for v in vals],
                   boundary_gaps_ms=boundary_gaps(run, ORBAX_EVERY, steps),
                   losses=losses[mode])
        # the stall a boundary adds to the step loop: its fetch gap less a
        # steady step and the boundary's eval
        run["stall_ms"] = [g - run["step_ms"] - e * 1e3 for g, e in
                           zip(run["boundary_gaps_ms"], run["eval_s"])]
        out[mode] = run
        log(f"orbax {mode}: XE bf16 B=100x5, {steps} steps with boundaries at "
            f"{list(range(ORBAX_EVERY, steps, ORBAX_EVERY))}; steady step "
            f"{run['step_ms']:.2f} ms; boundary fetch gaps "
            f"{[round(g, 1) for g in run['boundary_gaps_ms']]} ms (eval "
            f"{[round(e, 3) for e in run['eval_s']]} s, host time in the save "
            f"{[round(s, 3) for s in run['boundary_save_s']]} s; stall beyond the step and "
            f"the eval {[round(s, 1) for s in run['stall_ms']]} ms); save_checkpoint returned "
            f"after {[round(e['returned_s'], 3) for e in saves]} s, its write done after "
            f"{[round(e['done_s'], 3) for e in saves]} s; rolling triple "
            f"{run['triple_bytes'] / 1e9:.3f} GB (bytes {files}); "
            f"launches {run['launches']}; wall {run['wall_s']:.2f} s on {card}")
        if mode == "dcp_sync":
            # eval and eval_ensemble of the -best DCP triple
            ev_argv = ["--model_path", ck, "--checkpoint_backend", "orbax", "--eval_split",
                       "test", "--val_images_use", "100", "--beam_size", "3", "--batch_size",
                       "100", "--dtype", "bfloat16", "--device", DEVICE, "--eval_results_dir",
                       os.path.join(root, "eval_results")] + data_argv
            reset_counters(counters)
            t1 = time.perf_counter()
            with recorder.run("orbax_eval"):
                loss, preds, stats = eval_cli.main(ev_argv + ["--load_model_id", "ox"])
            torch.cuda.synchronize()
            ev_launches = read_counters(counters, "orbax eval")
            if ev_launches != (per_eval, 0) or recorder.totals("orbax_eval") != ev_launches \
                    or len(preds) != 100 or not math.isfinite(loss):
                raise AssertionError(f"orbax eval: launches {ev_launches}, {len(preds)} "
                                     f"predictions, loss {loss}")
            out["eval"] = dict(wall_s=time.perf_counter() - t1, loss=loss,
                               stats=check_stats(stats, "orbax eval"), launches=ev_launches)
            out["eval_ensemble"] = run_ensemble_cli(
                torch, ens_cli, ev_argv + ["--model_ids", "ox"], counters, (64, 0),
                "orbax eval_ensemble", recorder, "orbax_ensemble")
            log(f"orbax: eval of the -best DCP triple (test, 100 images, beam 3, bf16): loss "
                f"{loss:.4f}, metrics {out['eval']['stats']}, {out['eval']['wall_s']:.2f} s; "
                f"eval_ensemble of it: metrics {out['eval_ensemble']['stats']}, "
                f"{out['eval_ensemble']['wall_s']:.2f} s on {card}")
            # a third run resumes the first boundary's rolling DCP triple and
            # runs to the end, without a boundary of its own (its write at
            # the last step was cut for time)
            ck_r = os.path.join(root, "resumed")
            infos, resumed = run_driver(
                torch, main_cli,
                xe + flags + ["--checkpoint_path", ck_r, "--max_iterations", str(ORBAX_STEPS),
                              "--start_from", snap, "--load_model_id", "ox",
                              "--save_checkpoint_every", str(10 ** 6)],
                counters, (65 * (ORBAX_STEPS - ORBAX_EVERY - 1),
                           65 * (ORBAX_STEPS - ORBAX_EVERY - 1)),
                "orbax resume", recorder, "orbax_resume")
            after = range(ORBAX_EVERY + 1, ORBAX_STEPS)
            got = [infos["loss_history"][i] for i in after]
            want = [losses["dcp_sync"][i] for i in after]
            del infos
            diff = max(abs(a - b) for a, b in zip(got, want))
            tol = BWD_TOL["bfloat16"]
            if not all(abs(a - b) <= tol["atol"] + tol["rtol"] * abs(b)
                       for a, b in zip(got, want)):
                raise AssertionError(f"orbax resume: losses {got} against the uninterrupted "
                                     f"run's {want}")
            out["resume"] = dict(resumed, bitwise=got == want, max_abs_diff=diff, losses=got)
            log(f"orbax resume: from the step-{ORBAX_EVERY} rolling DCP triple, steps "
                f"{after.start}..{after.stop - 1}: losses {got}; the uninterrupted run's {want}; "
                f"bit for bit {got == want}, max |diff| {diff:.3e} (bf16 tolerance rtol "
                f"{tol['rtol']} atol {tol['atol']}); steady step {resumed['step_ms']:.2f} ms "
                f"on {card}")
            shutil.rmtree(ck_r, ignore_errors=True)
            shutil.rmtree(snap)
        shutil.rmtree(ck)
    out["trace"] = trace_window(torch, card, counters, recorder, root, main_cli, common)
    return out


def trace_window(torch, card, counters, recorder, root, main_cli, common):
    """Phase 14 (c): main with --profile_dir / --profile_start /
    --profile_steps; the Chrome trace holds both kernels, as many launches
    as the counters read for the window's steps."""
    from unittest import mock

    from recurrent_fusion_network_torch.utils import profiling

    prof_dir = os.path.join(root, "trace")
    finish_s = []
    real_finish = profiling.TraceWindow._finish

    def finish(self):
        t = time.perf_counter()
        try:
            return real_finish(self)
        finally:
            finish_s.append(time.perf_counter() - t)

    with mock.patch.object(profiling.TraceWindow, "_finish", finish):
        _, run = run_driver(
            torch, main_cli, common + ["--save_checkpoint_every", "1000", "--checkpoint_path",
                                       os.path.join(root, "trace_ck"), "--max_iterations",
                                       str(TRACE_STEPS), "--profile_dir", prof_dir,
                                       "--profile_start", str(TRACE_START), "--profile_steps",
                                       str(TRACE_LEN)],
            counters, (65 * TRACE_STEPS, 65 * TRACE_STEPS), "trace window", recorder, "trace")
    files = os.listdir(prof_dir)
    name = f"trace_iters_{TRACE_START}-{TRACE_START + TRACE_LEN - 1}.json"
    if files != [name] or len(finish_s) != 1:
        raise AssertionError(f"trace window: files {files}, {len(finish_s)} windows closed")
    path = os.path.join(prof_dir, name)
    trace_mb = os.path.getsize(path) / 1e6
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == TRACE_KERNEL_CAT]
    counts = {k: sum(kname in n for n in kernels) for k, kname in KERNEL_NAMES.items()}
    want = {k: 65 * TRACE_LEN for k in KERNEL_NAMES}
    if counts != want:
        raise AssertionError(f"trace window: kernel events {counts} in the trace, the "
                             f"counters read {want} for its {TRACE_LEN} steps")
    # gap k is iteration k (fetch k + 1 is queued in iteration k's epilogue)
    gaps = run["fetch_gaps_ms"]
    inside = gaps[TRACE_START:TRACE_START + TRACE_LEN]
    outside = gaps[1:TRACE_START]
    out = dict(run, trace=name, trace_mb=trace_mb, kernel_events=counts,
               device_events=len(kernels), inside_ms=inside, outside_ms=outside,
               stop_and_export_s=finish_s[0])
    log(f"trace window: {name} ({trace_mb:.1f} MB, {len(kernels)} kernel events) holds "
        f"{counts} launches, the counters' {want} for steps {TRACE_START}.."
        f"{TRACE_START + TRACE_LEN - 1}; step ms inside the window "
        f"{[round(g, 2) for g in inside]}, outside {[round(g, 2) for g in outside]}; the "
        f"trace's stop and export {finish_s[0]:.2f} s; launches {run['launches']} on {card}")
    return out


def phase14(torch, aa, model, card, scorer):
    """Phase 14: (a) SPICE rewards in SCST and its fleet, (b) orbax
    (DCP) checkpoints, (c) the --profile_steps trace window. -> (results,
    forward rows, backward rows), the rows of every shape they met,
    checked against the plain versions."""
    t0 = time.perf_counter()
    recorder = ShapeRecorder(aa)
    out = {"spice": spice_rewards(torch, model, scorer, card, [aa], recorder)}
    torch.cuda.empty_cache()
    out["orbax"] = orbax_checkpoints(torch, model, card, [aa], recorder)
    out["trace"] = out["orbax"].pop("trace")
    torch.cuda.empty_cache()
    runs = {run: (run,) for run in PHASE14_RUNS}
    fwd_rows, bwd_rows = check_driver_sites(torch, aa, recorder, runs)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 14 in {out['seconds']:.2f} s: {len(recorder.fwd)} forward and "
        f"{len(recorder.bwd)} backward shapes checked against the plain versions")
    return out, fwd_rows, bwd_rows


PHASE14_RUNS = ("spice_approx", "spice_http", "spice_fleet", "orbax_pickle", "orbax_dcp_sync",
                "orbax_dcp_async", "orbax_eval", "orbax_ensemble", "orbax_resume", "trace")


# ------------------------------------------------- 15. data parallelism

DP_FREE_GB = 30  # data set ~1.6 GB; a pickle and a DCP flagship triple (5.4 GB each),
# two first-step grads files (1.8 GB each) and the pair's preemption triple
# the world-1 XE runs: steps 0..9, the boundary at 9 (8 steady gaps; cut from 16)
DP_XE_STEPS = 10
# main_rl from the XE best triple: iterations 10..15, no boundary (cut from 8)
DP_RL_ITERS = 6
PAIR_STEPS = 2  # steps or iterations of each gloo-pair run (cut from 3 for phase 17)
PAIR_XE_ARGS = ["--dtype", "float32", "--batch_size", "128", "--seq_per_img", "4"]  # B = 512
PAIR_RL_ARGS = ["--dtype", "float32", "--batch_size", "64", "--seq_per_img", "4"]  # B = 256
PAIR_FLEET_ARGS = ["--dtype", "bfloat16", "--batch_size", "100", "--seq_per_img", "5",
                   "--n_seeds", "2"]
PAIR_PREEMPT_ARGS = ["--dtype", "bfloat16", "--batch_size", "100", "--seq_per_img", "5"]
PAIR_TOL = {"xe": dict(rtol=1e-4, atol=1e-6), "scst": dict(rtol=2e-4, atol=1e-6)}
# The XE step has two switches: each reason head's amax over the review
# steps and the hinge of its margin loss. A rank's 256 rows round apart
# from one process's 512 (other GEMM shapes), so a few choices can switch
# and move some elements of the reason heads and the review cells behind
# them by up to 6e-6 on the card. Those leaves (SWITCH_LEAVES) are held to
# SWITCH_LEAF_TOL against the solo run, every other leaf to PAIR_TOL["xe"];
# and every leaf to PAIR_TOL["xe"] against the solo run made to take the
# pair's choices (``SwitchSpy``).
SWITCH_LEAVES = ("['reason_individual']", "['reason_linear']", "['review1']", "['review2']")
SWITCH_LEAF_TOL = dict(rtol=1e-4, atol=1e-5)
PAIR_TIMEOUT_S = 480
PAIR_DEVICE = "cuda:0"  # both ranks of the gloo pair share the card
PAIR_PORTS = "CHIP_SMOKE_PAIR_PORTS"  # the pair's three rendezvous ports, comma-separated
# the pair's dp 1 x mp 2 XE run (--num_mp_devices 2): the pair XE run's
# batch and steps, the boundary at the last step (a beam-3 eval of the 100
# val images in one batch, 65 + 64 launches, and the triple of the final
# params); each rank runs the whole replicated forward
MP_PAIR_ARGS = ["--num_mp_devices", "2", "--save_checkpoint_every", str(PAIR_STEPS - 1),
                "--val_images_use", "100", "--beam_size", "3", "--language_eval", "0"]
MP_PAIR_LAUNCHES = (65 * PAIR_STEPS + 65 + 64, 65 * PAIR_STEPS)
# phase 15's runs and their dtypes
PHASE15_RUNS = {"dp_solo_xe": "bfloat16", "dp_nccl_xe": "bfloat16", "dp_solo_rl": "float32",
                "dp_nccl_rl": "float32", "dp_solo_pair_xe": "float32", "dp_pair_xe": "float32",
                "dp_solo_pair_scst": "float32", "dp_pair_scst": "float32",
                "dp_solo_pair_fleet": "bfloat16", "dp_pair_fleet": "bfloat16",
                "dp_pair_preempt": "bfloat16", "mp_pair_xe": "float32"}


def quiet(*_args, **_kwargs):
    """A log_fn that drops the loops' lines."""


def run_group(cmd, timeout, what, env=None):
    """``cmd`` in a session of its own, to its end or ``timeout`` (then
    the whole session is killed): -> (seconds, output). Fails on a
    non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONUNBUFFERED="1", **(env or {})),
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{what}: not done within {timeout} s:\n{out[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}:\n{out[-4000:]}")
    return time.perf_counter() - t0, out


def probe_launches(calls, recorder, run, what):
    """The launch probe's lines ``calls`` (one per command) into
    ``recorder`` under ``run``; -> the launches (fwd, bwd) of those
    commands together."""
    total = [0, 0]
    for c in calls:
        if not c["ok"] or c["scalar"]:
            raise AssertionError(f"{what}: a command failed or took the scalar path: {c}")
        for table, rows in ((recorder.fwd, c["fwd"]), (recorder.bwd, c["bwd"])):
            for shape, n in rows:
                recorder._count(table, tuple(shape), run, n)
        total = [a + b for a, b in zip(total, c["launches"])]
    if tuple(total) != recorder.totals(run):
        raise AssertionError(f"{what}: launches {total} but {recorder.totals(run)} by shape")
    return tuple(total)


def cli_in_process(torch, cli, argv, counters, recorder, run, what):
    """One CLI run in this process under the shape recorder, the counters
    reset just before and read just after: -> (result, seconds, launches)."""
    torch.cuda.synchronize()
    reset_counters(counters)
    t0 = time.perf_counter()
    with recorder.run(run):
        out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters, what)
    if launches != recorder.totals(run):
        raise AssertionError(f"{what}: launches {launches}, by shape {recorder.totals(run)}")
    return out, wall, launches


def event_step_ms(path, event):
    """The median gap (ms) between a run's JSONL ``event`` lines past the
    first (each line is written when its step's loss is read), the gaps,
    and their quartiles."""
    ts = [e["ts"] for e in jsonl(path, event)]
    gaps = [(b - a) * 1e3 for a, b in zip(ts, ts[1:])][1:]
    quartiles = statistics.quantiles(gaps, n=4) if len(gaps) > 1 else gaps * 3
    return statistics.median(gaps), gaps, [quartiles[0], quartiles[2]]


def dp_world1(torch, model, card, counters, recorder, root, data_argv):
    """Phase 15 (a): the XE CLI at phase 8's shapes (bf16, 100 x 5, steps
    0..DP_XE_STEPS - 1, the boundary at the last) and main_rl from its best
    triple (f32, 51 x 5, DP_RL_ITERS iterations) in this process, then both
    in one process under torch.distributed.run --standalone
    --nproc_per_node 1 (an NCCL group of one, joined by each CLI in turn:
    the all-reduce, rank 0's writes, a collective DCP save): equal losses
    bit for bit, the DCP triple's tree equal to the solo run's pickle
    triple; step ms of each against the other (medians of the JSONL
    gaps)."""
    from recurrent_fusion_network_torch import main as main_cli
    from recurrent_fusion_network_torch import main_rl as main_rl_cli
    from recurrent_fusion_network_torch.training import checkpoint, orbax_ckpt

    per_eval = 65 + 64
    common = data_argv + ["--device", DEVICE, "--eval_results_dir",
                          os.path.join(root, "eval_results"), "--val_images_use", "100",
                          "--beam_size", "3", "--language_eval", "1", "--seed", "0",
                          "--losses_log_every", "1"]
    xe = common + ["--dtype", "bfloat16", "--batch_size", "100", "--seq_per_img", "5",
                   "--max_iterations", str(DP_XE_STEPS), "--save_checkpoint_every",
                   str(DP_XE_STEPS - 1)]
    rl = common + ["--dtype", "float32", "--batch_size", "51", "--seq_per_img", "5",
                   "--max_iterations", str(DP_XE_STEPS + DP_RL_ITERS),
                   "--save_checkpoint_every", str(10 ** 6),
                   "--cider_df", os.path.join(root, "absent.p")]
    ck = {k: os.path.join(root, f"ck_{k}") for k in ("solo", "nccl")}
    flags = {"solo": [], "nccl": ["--checkpoint_backend", "orbax"]}
    expect = {"xe": (65 * DP_XE_STEPS + per_eval, 65 * DP_XE_STEPS),
              "rl": (130 * DP_RL_ITERS, 65 * DP_RL_ITERS)}
    stages = (("xe", main_cli, "main", "train"), ("rl", main_rl_cli, "main_rl", "rl_train"))
    logs = {(stage, kind): os.path.join(root, f"{stage}_{kind}.jsonl")
            for stage, *_ in stages for kind in ck}

    def argv(stage, kind):
        return (xe if stage == "xe" else rl + ["--start_from", ck[kind], "--load_model_id",
                                               kind]) \
            + flags[kind] + ["--checkpoint_path", ck[kind], "--id", kind, "--json_log",
                             logs[stage, kind]]

    out = {}
    for stage, cli, module, _ in stages:
        run = f"dp_solo_{stage}"
        _, wall, launches = cli_in_process(torch, cli, argv(stage, "solo"), counters,
                                           recorder, run, f"dp solo {module}")
        out[run] = dict(wall_s=wall, launches=launches)
    probe_log = os.path.join(root, "probe.jsonl")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", os.path.abspath(__file__), "--launch-probe", probe_log]
    for i, (stage, _, module, _) in enumerate(stages):
        cmd += ([PROBE_THEN] if i else []) + ["-m", f"recurrent_fusion_network_torch.{module}",
                                              *argv(stage, "nccl")]
    wall, _ = run_group(cmd, 600, "dp NCCL world 1")
    with open(probe_log) as f:
        calls = [json.loads(line) for line in f]
    if len(calls) != len(stages):
        raise AssertionError(f"dp NCCL world 1: {len(calls)} probe lines: {calls}")
    out["nccl_wall_s"] = wall
    for (stage, _, module, event), call in zip(stages, calls):
        run, what = f"dp_nccl_{stage}", f"dp nccl {module}"
        out[run] = dict(wall_s=call["seconds"],
                        launches=probe_launches([call], recorder, run, what))
        for kind in ck:
            run = f"dp_{kind}_{stage}"
            if out[run]["launches"] != expect[stage]:
                raise AssertionError(f"dp {kind} {module}: launches {out[run]['launches']}, "
                                     f"expected {expect[stage]}")
            out[run].update(zip(("step_ms", "gaps_ms", "quartiles_ms"),
                                event_step_ms(logs[stage, kind], event)))
        keys = ("loss",) if stage == "xe" else ("avg_reward", "loss")
        solo, nccl = ([[e["iter"]] + [e[k] for k in keys]
                       for e in jsonl(logs[stage, kind], event)] for kind in ("solo", "nccl"))
        n = DP_XE_STEPS if stage == "xe" else DP_RL_ITERS
        if solo != nccl or len(solo) != n or not all(math.isfinite(x) for r in solo
                                                     for x in r[1:]):
            raise AssertionError(f"dp {module}: the NCCL world-1 run's {keys} differ from the "
                                 f"solo run's: {nccl} vs {solo}")
        out[f"{stage}_history"] = solo
        a, b = out[f"dp_solo_{stage}"], out[f"dp_nccl_{stage}"]
        log(f"dp world 1 {module}: {keys} bit for bit the solo CLI's over {n} steps "
            f"({solo[:3]} ...); step ms solo {a['step_ms']:.2f} (quartiles "
            f"{[round(x, 2) for x in a['quartiles_ms']]}), NCCL world 1 {b['step_ms']:.2f} "
            f"({[round(x, 2) for x in b['quartiles_ms']]}), NCCL / solo "
            f"{b['step_ms'] / a['step_ms']:.3f} (medians of {len(a['gaps_ms'])} JSONL gaps); "
            f"wall {a['wall_s']:.2f} s in this process, {b['wall_s']:.2f} s in the launched "
            f"one; launches {b['launches']} on {card}")
    # the boundary's triples: rank 0's collective DCP save reads back to the
    # solo run's pickle tree, leaf by leaf
    t0 = time.perf_counter()
    want, _ = checkpoint.load_checkpoint(ck["solo"], "solo", 0, best=False)
    got, infos = orbax_ckpt.load_checkpoint(ck["nccl"], "nccl", 0, best=False)
    leaves, got_leaves = list(_paths(want)), list(_paths(got))
    apart = [(p, q, str(a.dtype), str(b.dtype), a.shape, b.shape)
             for (p, a), (q, b) in zip(leaves, got_leaves)
             if p != q or a.dtype != b.dtype or a.shape != b.shape or not (a == b).all()]
    if apart or len(got_leaves) != len(leaves) or infos["iter"] != DP_XE_STEPS:
        raise AssertionError(f"dp: the DCP triple's tree ({len(got_leaves)} leaves, iter "
                             f"{infos['iter']}) differs from the pickle one's ({len(leaves)}) "
                             f"at {apart[:5]}")
    files = sorted(os.listdir(ck["nccl"]))
    out["dcp"] = dict(leaves=len(leaves), files=files, read_s=time.perf_counter() - t0)
    log(f"dp world 1: the NCCL run's DCP triple ({files}) reads back to the solo run's "
        f"pickle tree, all {len(leaves)} leaves bit for bit; torch.distributed.run's "
        f"command {wall:.2f} s")
    del want, got
    for path in ck.values():
        shutil.rmtree(path, ignore_errors=True)
    return out


class StepTimer:
    """The device time of each step of a run (the step function timed with
    a synchronise on either side) and of each gradient all-reduce in it."""

    def __init__(self, torch):
        self.torch, self.step_ms, self.reduce_ms = torch, [], []

    def _timed(self, fn, into):
        def call(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def factory(self, make):
        """``make`` (make_train_step / make_rl_step) with its step timed."""
        def wrapped(*a, **kw):
            out = make(*a, **kw)
            if isinstance(out, tuple):
                return (self._timed(out[0], self.step_ms),) + out[1:]
            return self._timed(out, self.step_ms)
        return wrapped

    @contextlib.contextmanager
    def mesh(self, mesh):
        if mesh is None:
            yield
            return
        mesh.all_reduce_grads = self._timed(type(mesh).all_reduce_grads.__get__(mesh),
                                            self.reduce_ms)
        try:
            yield
        finally:
            del mesh.all_reduce_grads

    def summary(self):
        med = lambda xs: statistics.median(xs) if xs else None  # noqa: E731
        return dict(step_ms=self.step_ms, step_median_ms=med(self.step_ms),
                    all_reduce_ms=self.reduce_ms, all_reduce_median_ms=med(self.reduce_ms))


class MpStepTimer(StepTimer):
    """``StepTimer`` with the ms of the mp collectives inside each step
    (``parallel/mesh.py``'s ``_all_gather`` and ``_all_reduce``, each timed
    with a synchronise on either side) summed per step."""

    def __init__(self, torch):
        super().__init__(torch)
        self.mp_ms, self._acc = [], None

    def factory(self, make):
        timed = super().factory(make)

        def wrapped(*a, **kw):
            step = timed(*a, **kw)

            def call(*args, **kws):
                self._acc = 0.0
                try:
                    return step(*args, **kws)
                finally:
                    self.mp_ms.append(self._acc)
                    self._acc = None
            return call
        return wrapped

    @contextlib.contextmanager
    def collectives(self):
        from unittest import mock

        from recurrent_fusion_network_torch.parallel import mesh as mesh_mod

        def timed(fn):
            def call(*a, **kw):
                if self._acc is None:  # outside a step: the boundary's gathers
                    return fn(*a, **kw)
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.torch.cuda.synchronize()
                self._acc += (time.perf_counter() - t0) * 1e3
                return out
            return call

        with mock.patch.object(mesh_mod, "_all_gather", timed(mesh_mod._all_gather)), \
                mock.patch.object(mesh_mod, "_all_reduce", timed(mesh_mod._all_reduce)):
            yield

    def summary(self):
        med = statistics.median(self.mp_ms) if self.mp_ms else None
        return dict(super().summary(), mp_collective_ms=self.mp_ms,
                    mp_collective_median_ms=med)


def params_digest(torch, tree):
    """A digest of every leaf's bytes, in order (bit-for-bit comparisons
    across processes)."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for _, t in _paths(tree):
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class SwitchSpy:
    """The XE step's switches on its first step: which review step each
    reason head's amax takes (``Tensor.amax`` over the stacked steps, the
    step's only amax) and which terms of each head's hinge are on (the
    ``torch.relu`` of ``losses.multilabel_margin_loss``, the step's only
    relu), with the terms the loss counts (valid targets against the
    other classes). Without ``forced`` it records them and leaves the
    step's numbers as they are; with ``forced`` (a record, rows in global
    order) the step takes those choices instead."""

    def __init__(self, torch, forced=None):
        self.torch, self.forced = torch, forced
        self.record = {"picks": [], "hinges": [], "counted": []}
        self.first, self.active = True, False

    def factory(self, make):
        """``make`` (make_train_step) with the spy active in its first step."""
        def wrapped(*a, **kw):
            out = make(*a, **kw)
            step = out[0] if isinstance(out, tuple) else out

            def call(*args, **kws):
                self.active = self.first
                try:
                    return step(*args, **kws)
                finally:
                    self.active = self.first = False
            return (call,) + tuple(out[1:]) if isinstance(out, tuple) else call
        return wrapped

    @contextlib.contextmanager
    def patched(self):
        from unittest import mock

        from recurrent_fusion_network_torch.ops import losses

        torch, rec, forced = self.torch, self.record, self.forced
        real_amax, real_relu, real_loss = torch.Tensor.amax, torch.relu, \
            losses.multilabel_margin_loss

        def amax(t, *args, **kw):
            if not self.active:
                return real_amax(t, *args, **kw)
            if (args[:1] or [kw.get("dim")])[0] != 0 or t.dim() != 3:
                raise AssertionError(f"switch spy: an amax it does not know, {t.shape}")
            i = len(rec["picks"])
            if forced is None:
                rec["picks"].append(t.detach().argmax(dim=0).to(torch.uint8).cpu())
                return real_amax(t, *args, **kw)
            rec["picks"].append(forced["picks"][i])
            idx = forced["picks"][i].to(device=t.device, dtype=torch.int64)
            return t.gather(0, idx[None]).squeeze(0)

        def relu(t):
            if not self.active:
                return real_relu(t)
            i = len(rec["hinges"])
            if forced is None:
                rec["hinges"].append((t.detach() > 0).cpu())
                return real_relu(t)
            rec["hinges"].append(forced["hinges"][i])
            return t * forced["hinges"][i].to(device=t.device, dtype=t.dtype)

        def margin_loss(x, y, *, max_targets=None):
            if self.active:  # the terms the loss counts, as it masks them
                C = x.shape[1]
                if max_targets is not None and y.shape[1] > max_targets:
                    y = y[:, :max_targets]
                valid = torch.cumprod((y >= 0).to(torch.int32), dim=1).bool()
                one_hot = torch.nn.functional.one_hot(torch.where(valid, y, 0), C) \
                    * valid[..., None]
                other = one_hot.sum(dim=1) == 0
                rec["counted"].append((valid[:, :, None] & other[:, None, :]).cpu())
            return real_loss(x, y, max_targets=max_targets)

        with mock.patch.object(torch.Tensor, "amax", amax), \
                mock.patch.object(torch, "relu", relu), \
                mock.patch.object(losses, "multilabel_margin_loss", margin_loss):
            yield self


def switches_apart(solo, ranks):
    """The choices of the solo record ``solo`` that the ranks' records
    (each its rows, in rank order) took the other way: -> (the ranks'
    record joined in global row order, amax picks apart, counted hinge
    terms apart)."""
    import torch

    joined = {k: [torch.cat(parts) for parts in zip(*(r[k] for r in ranks))]
              for k in ("picks", "hinges", "counted")}
    picks = sum(int((a != b).sum()) for a, b in zip(solo["picks"], joined["picks"]))
    hinges = sum(int(((a ^ b) & c).sum())
                 for a, b, c in zip(solo["hinges"], joined["hinges"], solo["counted"]))
    if [t.shape for t in solo["hinges"]] != [t.shape for t in joined["hinges"]] or \
            [t.shape for t in solo["hinges"]] != [t.shape for t in solo["counted"]] or \
            len(solo["picks"]) != len(joined["picks"]) or not solo["picks"]:
        raise AssertionError("switch spy: the records of the solo run and the pair differ "
                             "in shape")
    return joined, picks, hinges


def pair_options(spec, extra):
    """The options of a gloo-pair run (and of its solo counterpart)."""
    from recurrent_fusion_network_torch.config import parse_opt

    return parse_opt(spec["data_argv"] + extra + [
        "--device", DEVICE, "--max_iterations", str(PAIR_STEPS), "--seed", "0",
        "--save_checkpoint_every", str(10 ** 6), "--losses_log_every", "1",
        "--checkpoint_path", os.path.join(spec["root"], "pair_ck"), "--id", "pair"])


def forced_first_grads(torch, spec, forced):
    """The solo XE run's first step made to take the choices ``forced``
    (``SwitchSpy``): -> its grads as they reach the optimizer, on the host,
    by path."""
    from unittest import mock

    from recurrent_fusion_network_torch.data.build import build_loader
    from recurrent_fusion_network_torch.training import train_loop

    opt, spies, spy = pair_options(spec, PAIR_XE_ARGS), [], SwitchSpy(torch, forced)
    loader = build_loader(opt)
    real_make = train_loop.make_optimizer
    try:
        with mock.patch.object(train_loop, "make_optimizer",
                               lambda o: spies.append(GradSpy(real_make(o))) or spies[-1]), \
                mock.patch.object(train_loop, "make_train_step",
                                  spy.factory(train_loop.make_train_step)), spy.patched():
            train_loop.train(opt, loader, max_iterations=1, log_fn=quiet)
    finally:
        loader.close()
    if len(spy.record["picks"]) != len(forced["picks"]):
        raise AssertionError("switch spy: the forced step made another number of choices")
    return {p: g.cpu() for p, g in _paths(spies[0].grads)}


def pair_runs(torch, spec, mesh, counters, recorder, prefix):
    """The gloo pair's training paths, or (``mesh`` None) the same in one
    process on the same global batches: XE f32 at B = 512 rows, SCST f32 at
    B = 256, each PAIR_STEPS steps, then the S = 2 XE fleet (bf16, 100 x 5;
    over the pair, each rank one seed). -> results; the first step's grads
    (as it reaches the optimizer) of XE and SCST, on the host, by path; the
    XE step's first choices (``SwitchSpy``'s record)."""
    from unittest import mock

    from recurrent_fusion_network_torch.data.build import build_loader
    from recurrent_fusion_network_torch.main_rl import make_scorer
    from recurrent_fusion_network_torch.training import train_loop, train_rl_loop
    from recurrent_fusion_network_torch.training.multi_seed import train_multi_seed

    out, grads, switch = {}, {}, SwitchSpy(torch)
    for stage, module, extra in (("xe", train_loop, PAIR_XE_ARGS),
                                 ("scst", train_rl_loop, PAIR_RL_ARGS)):
        opt = pair_options(spec, extra)
        loader = build_loader(opt)
        spies, timer = [], StepTimer(torch)
        real_make = module.make_optimizer
        make_step = "make_train_step" if stage == "xe" else "make_rl_step"
        step_factory = getattr(module, make_step)
        if stage == "xe":
            step_factory = switch.factory(step_factory)
        run = f"{prefix}_{stage}"
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters(counters)
            with mock.patch.object(module, "make_optimizer",
                                   lambda o: spies.append(GradSpy(real_make(o))) or spies[-1]), \
                    mock.patch.object(module, make_step, timer.factory(step_factory)), \
                    switch.patched() if stage == "xe" else contextlib.nullcontext(), \
                    timer.mesh(mesh), recorder.run(run):
                if stage == "xe":
                    infos = train_loop.train(opt, loader, max_iterations=PAIR_STEPS,
                                             log_fn=quiet, mesh=mesh)
                else:
                    scorer = make_scorer(os.path.join(spec["root"], "absent.p"), loader,
                                         log_fn=quiet)
                    infos = train_rl_loop.train_rl(opt, loader, scorer,
                                                   max_iterations=PAIR_STEPS, log_fn=quiet,
                                                   mesh=mesh)
            torch.cuda.synchronize()
            launches = read_counters(counters, run)
        finally:
            loader.close()
        hist = [infos["loss_history"][i] for i in range(PAIR_STEPS)]
        out[stage] = dict(loss_history=hist, launches=launches,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9, **timer.summary())
        if stage == "scst":
            out[stage]["train_loss_history"] = [infos["train_loss_history"][i]
                                                for i in range(PAIR_STEPS)]
        grads[stage] = {p: g.cpu() for p, g in _paths(spies[0].grads)}
        del infos, spies
        torch.cuda.empty_cache()
    opt = pair_options(spec, PAIR_FLEET_ARGS)
    loader = build_loader(opt)
    run = f"{prefix}_fleet"
    try:
        reset_counters(counters)
        with recorder.run(run):
            fleet = train_multi_seed(opt, loader, 2, max_iterations=PAIR_STEPS,
                                     eval_at_end=False, save=False, log_fn=quiet, mesh=mesh)
        torch.cuda.synchronize()
        launches = read_counters(counters, run)
    finally:
        loader.close()
    out["fleet"] = dict(ranks=fleet["ranks"], launches=launches,
                        loss_histories=[[h[i] for i in range(PAIR_STEPS)]
                                        for h in fleet["loss_histories"]],
                        digests=[params_digest(torch, p) for p in fleet["params"]])
    del fleet
    torch.cuda.empty_cache()
    return out, grads, switch.record


def mp_pair_run(torch, spec, mesh, counters, recorder, out_dir, rank):
    """The pair's dp 1 x mp 2 XE run (``mesh`` from ``make_mesh_2d(1, 2)``):
    the pair XE run's options with --num_mp_devices 2, PAIR_STEPS steps,
    the boundary at the last. -> (results: losses, launches, step and mp
    collective ms, peak GB, digests of the final params and of the first
    step's grads, both gathered, and on rank 0 whether the boundary's
    triple reads back as the final params bit for bit; the first step's
    grads gathered to the full tree, on the host, by path)."""
    from unittest import mock

    from recurrent_fusion_network_torch.config import parse_opt
    from recurrent_fusion_network_torch.convert import params_from_jax
    from recurrent_fusion_network_torch.data.build import build_loader
    from recurrent_fusion_network_torch.parallel.mesh import gather_params_2d
    from recurrent_fusion_network_torch.training import checkpoint, train_loop

    ck = os.path.join(out_dir, "mp_ck")
    opt = parse_opt(spec["data_argv"] + PAIR_XE_ARGS + [
        "--device", DEVICE, "--max_iterations", str(PAIR_STEPS), "--seed", "0",
        "--losses_log_every", "1", "--eval_results_dir", os.path.join(out_dir, "mp_er"),
        "--checkpoint_path", ck, "--id", "mp"] + MP_PAIR_ARGS)
    loader = build_loader(opt)
    spies, timer = [], MpStepTimer(torch)
    real_make = train_loop.make_optimizer
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(counters)
        with mock.patch.object(train_loop, "make_optimizer",
                               lambda o: spies.append(GradSpy(real_make(o))) or spies[-1]), \
                mock.patch.object(train_loop, "make_train_step",
                                  timer.factory(train_loop.make_train_step)), \
                timer.collectives(), recorder.run("mp_pair_xe"):
            infos = train_loop.train(opt, loader, max_iterations=PAIR_STEPS, log_fn=quiet,
                                     mesh=mesh)
        torch.cuda.synchronize()
        launches = read_counters(counters, "mp pair xe")
    finally:
        loader.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shard = spies[0].grads
    shapes = {"logit_w": list(shard["logit"]["w"].shape), "embed": list(shard["embed"].shape)}
    grads = {p: g.cpu() for p, g in _paths(gather_params_2d(mesh, shard))}
    final = infos["final_params"]
    res = dict(loss_history=[infos["loss_history"][i] for i in range(PAIR_STEPS)],
               launches=launches, peak_gb=peak_gb, shard_shapes=shapes,
               final_digest=params_digest(torch, final),
               grads_digest=params_digest(torch, grads), **timer.summary())
    if rank == 0:
        t0 = time.perf_counter()
        saved, saved_infos = checkpoint.load_checkpoint(ck, "mp", 0, best=False)
        saved = dict(_paths(params_from_jax(saved)))
        res["triple_equal"] = saved_infos["iter"] == PAIR_STEPS and sorted(saved) == sorted(
            p for p, _ in _paths(final)) and all(
            torch.equal(t.cpu().view(torch.int32), saved[p].view(torch.int32))
            for p, t in _paths(final))
        res["triple_read_s"] = time.perf_counter() - t0
        del saved
    del infos, spies, final, shard
    torch.cuda.empty_cache()
    return res, grads


def dp_pair_rank(out_dir):
    """``chip_smoke.py --dp-pair-rank DIR``: one rank of the gloo pair on
    cuda:0 (the environment of torch.distributed.run set by the parent,
    with three rendezvous ports in PAIR_PORTS): ``pair_runs`` over the pair,
    the pair joined again as dp 1 x mp 2 (``mp_pair_run``), then joined as
    dp 2 for an XE run until a SIGTERM reaches either rank. Writes DIR/rank{r}.json and DIR/switches{r}.pt (the XE
    step's first choices), and rank 0 the first-step grads to
    DIR/grads.pt."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from recurrent_fusion_network_torch.config import parse_opt
    from recurrent_fusion_network_torch.data.build import build_loader
    from recurrent_fusion_network_torch.kernels import additive_attention as aa
    from recurrent_fusion_network_torch.parallel import distributed
    from recurrent_fusion_network_torch.parallel.mesh import make_mesh, make_mesh_2d
    from recurrent_fusion_network_torch.training.train_loop import train

    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    ports = os.environ[PAIR_PORTS].split(",")

    def join(k, mp):
        # a group's dp x mp layout is fixed when it is joined: each layout
        # is a group of its own, on its own rendezvous port
        distributed.shutdown()
        os.environ["MASTER_PORT"] = ports[k]
        return distributed.initialize(backend="gloo", device=PAIR_DEVICE, mp=mp)

    c = join(0, 1)
    try:
        mesh, recorder = make_mesh(2), ShapeRecorder(aa)
        res, grads, switches = pair_runs(torch, spec, mesh, [aa], recorder, "dp_pair")
        torch.save(switches, os.path.join(out_dir, f"switches{c.rank}.pt"))
        if c.rank == 0:
            torch.save(grads, os.path.join(out_dir, "grads.pt"))
        del grads, switches
        # the same pair laid out as dp 1 x mp 2, then as dp 2 again
        join(1, 2)
        res["mp"], grads = mp_pair_run(torch, spec, make_mesh_2d(1, 2), [aa], recorder,
                                       out_dir, c.rank)
        if c.rank == 0:
            torch.save(grads, os.path.join(out_dir, "mp_grads.pt"))
        del grads
        join(2, 1)
        mesh = make_mesh(2)
        opt = parse_opt(spec["data_argv"] + PAIR_PREEMPT_ARGS + [
            "--device", DEVICE, "--seed", "0", "--losses_log_every", "1",
            "--save_checkpoint_every", str(10 ** 6), "--checkpoint_path",
            os.path.join(out_dir, "preempt"), "--id", "pre"])
        loader = build_loader(opt)
        try:
            reset_counters([aa])
            log(f"dp pair rank {c.rank}: the preemption run starts")
            with recorder.run("dp_pair_preempt"):
                infos = train(opt, loader, max_iterations=10 ** 6, log_fn=log, mesh=mesh)
            torch.cuda.synchronize()
            res["preempt"] = dict(iter=infos["iter"],
                                  launches=read_counters([aa], "dp pair preempt"))
        finally:
            loader.close()
        res.update(rank=c.rank, device=str(c.device), backend=c.backend,
                   fwd=[[list(k), v] for k, v in recorder.fwd.items()],
                   bwd=[[list(k), v] for k, v in recorder.bwd.items()])
        with open(os.path.join(out_dir, f"rank{c.rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        distributed.shutdown()


def grads_apart(got, want, tol_of):
    """The largest share of its tolerance (``tol_of(path)``) by which a
    grad leaf of ``got`` is off ``want`` (the score biases, whose true
    gradient is 0, against atol alone), the leaves beyond it, and the five
    worst leaves as (path, share, max |diff|, max |want|)."""
    shares = []
    for path, b in want.items():
        a, tol = got[path], tol_of(path)
        rtol = 0.0 if _score_bias(path) else tol["rtol"]
        share = ((a - b).abs() / (tol["atol"] + rtol * b.abs())).max().item()
        shares.append((path, share, (a - b).abs().max().item(), b.abs().max().item()))
    shares.sort(key=lambda x: -x[1])
    return shares[0][1], [p for p, sh, _, _ in shares if sh > 1], shares[:5]


def pair_grad_tol(stage):
    """-> tol_of(path) for the pair's first-step grads against the solo
    run's: SWITCH_LEAF_TOL on XE's SWITCH_LEAVES, else PAIR_TOL[stage]."""
    tol = PAIR_TOL[stage]
    if stage != "xe":
        return lambda path: tol
    return lambda path: SWITCH_LEAF_TOL if path.startswith(SWITCH_LEAVES) else tol


def switch_check(torch, spec, pair_dir, solo_switches, solo_grads, rank_grads):
    """The XE step's first choices on the pair against the solo run's
    (``SwitchSpy``): how many amax picks and counted hinge terms switched;
    then the solo run's first step made to take the pair's choices, whose
    grads must match the pair's on every leaf within PAIR_TOL["xe"]."""
    tol = PAIR_TOL["xe"]
    ranks = [torch.load(os.path.join(pair_dir, f"switches{r}.pt")) for r in range(2)]
    joined, picks, hinges = switches_apart(solo_switches, ranks)
    t0 = time.perf_counter()
    forced = forced_first_grads(torch, spec, joined)
    forced_s = time.perf_counter() - t0
    worst, bad, top = grads_apart(rank_grads, forced, lambda path: tol)
    moved, moved_leaves, moved_top = grads_apart(forced, solo_grads, lambda path: tol)
    out = dict(amax_picks=sum(t.numel() for t in joined["picks"]), amax_switched=picks,
               hinge_terms=sum(int(t.sum()) for t in solo_switches["counted"]),
               hinge_switched=hinges, forced_worst_share=worst, forced_worst_leaves=top,
               forced_vs_solo_share=moved, forced_vs_solo_leaves=moved_leaves,
               forced_vs_solo_worst=moved_top, forced_s=forced_s)
    log(f"dp pair xe switches: {picks} of {out['amax_picks']} amax picks over the review "
        f"steps and {hinges} of {out['hinge_terms']} counted hinge terms took the other "
        f"side on the pair; the solo step made to take the pair's choices moved "
        f"{len(moved_leaves)} leaves beyond rtol {tol['rtol']} / atol {tol['atol']} of the "
        f"solo step ({moved_top[:len(moved_leaves)]}); against the pair's grads, every leaf "
        f"at rtol {tol['rtol']} / atol {tol['atol']}: worst share {worst:.3f} ({top[:2]}); "
        f"{forced_s:.2f} s")
    if bad:
        raise AssertionError(f"dp pair xe: with the pair's choices the solo step's grads are "
                             f"beyond rtol {tol['rtol']} / atol {tol['atol']} of the pair's at "
                             f"{bad}: {top}")
    return out


def dp_pair(torch, card, counters, recorder, root, data_argv):
    """Phase 15 (b): the same global batches in this process, then over
    two gloo ranks sharing cuda:0 (``dp_pair_rank``), and the SIGTERM to
    rank 1 alone while both train."""
    spec = {"data_argv": data_argv, "root": root}
    t0 = time.perf_counter()
    solo, solo_grads, solo_switches = pair_runs(torch, spec, None, counters, recorder,
                                                "dp_solo_pair")
    solo_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    pair_dir = os.path.join(root, "pair")
    os.makedirs(pair_dir)
    with open(os.path.join(pair_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    from recurrent_fusion_network_torch.parallel.distributed import free_port

    ports = set()
    while len(ports) < 3:  # the pair's dp, dp 1 x mp 2 and dp groups
        ports.add(str(free_port()))
    procs, lines = [], []
    t0 = time.perf_counter()
    try:
        for r in range(2):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", WORLD_SIZE="2", RANK=str(r),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2", PYTHONUNBUFFERED="1",
                       **{PAIR_PORTS: ",".join(sorted(ports)), "MASTER_PORT": min(ports)})
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-pair-rank", pair_dir],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
        lines = [ChildLines(p) for p in procs]
        lines[1].wait_for("the preemption run starts", PAIR_TIMEOUT_S)
        lines[0].wait_for("iter 0,", 120)  # the signal lands in iteration 1
        t_sig = time.perf_counter()
        os.kill(procs[1].pid, signal.SIGTERM)
        for p in procs:
            p.wait(timeout=max(1.0, PAIR_TIMEOUT_S - (time.perf_counter() - t0)))
        stop_s = time.perf_counter() - t_sig
    except (AssertionError, subprocess.TimeoutExpired) as e:
        for p in procs:
            p.kill()
        raise AssertionError(f"dp pair: {e}\n" + "\n".join(
            f"rank {r}:\n{x.text(10)[-3000:]}" for r, x in enumerate(lines))) from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    texts = [x.text() for x in lines]
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"dp pair: exit codes {[p.returncode for p in procs]}:\n"
                             + "\n".join(t[-3000:] for t in texts))
    pair_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(pair_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        for key, table in (("fwd", recorder.fwd), ("bwd", recorder.bwd)):
            for shape, runs in ranks[r][key]:
                for run, n in runs.items():
                    recorder._count(table, tuple(shape), run, n)
    rank_grads = torch.load(os.path.join(pair_dir, "grads.pt"))
    out = {"solo": solo, "ranks": ranks, "solo_s": solo_s, "pair_s": pair_s,
           "sigterm_to_exit_s": stop_s}
    for stage in ("xe", "scst"):
        keys = ("loss_history",) + (("train_loss_history",) if stage == "scst" else ())
        tol = PAIR_TOL[stage]
        for k in keys:
            for res in ranks:
                a, b = res[stage][k], solo[stage][k]
                if not all(abs(x - y) <= tol["atol"] + tol["rtol"] * abs(y)
                           for x, y in zip(a, b)) or len(a) != len(b):
                    raise AssertionError(f"dp pair {stage} {k}: rank {res['rank']} {a} vs "
                                         f"solo {b}")
        worst, bad, top = grads_apart(rank_grads[stage], solo_grads[stage],
                                      pair_grad_tol(stage))
        if bad:
            raise AssertionError(f"dp pair {stage}: first-step grads beyond rtol {tol['rtol']} "
                                 f"/ atol {tol['atol']} (XE's {SWITCH_LEAVES}: "
                                 f"{SWITCH_LEAF_TOL}) at {bad}; the worst (path, share, max "
                                 f"|diff|, max |solo|): {top}")
        tight, beyond, tight_top = grads_apart(rank_grads[stage], solo_grads[stage],
                                               lambda path: tol)
        out[stage + "_grads"] = dict(tol=tol, worst_share=worst, worst_leaves=top,
                                     share_of_tol_everywhere=tight,
                                     leaves_beyond_tol_everywhere=beyond,
                                     worst_leaves_at_tol_everywhere=tight_top)
        if stage == "xe":
            out["xe_switches"] = switch_check(torch, spec, pair_dir, solo_switches,
                                              solo_grads["xe"], rank_grads["xe"])
        if any(tuple(res[stage]["launches"]) != tuple(solo[stage]["launches"])
               for res in ranks):
            raise AssertionError(f"dp pair {stage}: launches per rank "
                                 f"{[res[stage]['launches'] for res in ranks]}, solo "
                                 f"{solo[stage]['launches']}")
        log(f"dp pair {stage} f32 (gloo, 2 ranks on cuda:0, "
            f"{'512 rows split 256 / 256' if stage == 'xe' else '256 rows split 128 / 128'}):"
            f" {keys} within rtol {tol['rtol']} / atol {tol['atol']} of the solo run's "
            f"({ranks[0][stage]['loss_history']} vs {solo[stage]['loss_history']}); "
            f"first-step grads over {len(solo_grads[stage])} leaves: worst share "
            f"{worst:.3f} of rtol {tol['rtol']} / atol {tol['atol']}"
            f"{f' (SWITCH_LEAVES: {SWITCH_LEAF_TOL})' if stage == 'xe' else ''}, {tight:.3f} "
            f"with every leaf at rtol {tol['rtol']} / atol {tol['atol']} ({len(beyond)} leaves "
            f"beyond it: {tight_top[:len(beyond)]}); step ms per rank "
            f"{[round(res[stage]['step_median_ms'], 2) for res in ranks]} (solo "
            f"{solo[stage]['step_median_ms']:.2f}), of which the all-reduce "
            f"{[round(res[stage]['all_reduce_median_ms'], 2) for res in ranks]}; peak GB "
            f"per process {[round(res[stage]['peak_gb'], 2) for res in ranks]} (solo "
            f"{solo[stage]['peak_gb']:.2f}); launches per rank "
            f"{[tuple(res[stage]['launches']) for res in ranks]}, solo "
            f"{tuple(solo[stage]['launches'])} on {card}")
    out["mp"] = mp_pair_check(torch, solo["xe"], solo_grads["xe"], ranks, pair_dir, card)
    del rank_grads, solo_grads
    fleet = solo["fleet"]
    for res in ranks:
        for i, r in enumerate(res["fleet"]["ranks"]):
            if res["fleet"]["digests"][i] != fleet["digests"][r] or \
                    res["fleet"]["loss_histories"][i] != fleet["loss_histories"][r]:
                raise AssertionError(f"dp pair fleet: seed {r} on rank {res['rank']} differs "
                                     f"from the single-process fleet's seed")
    summed = tuple(map(sum, zip(*(res["fleet"]["launches"] for res in ranks))))
    if [res["fleet"]["ranks"] for res in ranks] != [[0], [1]] or summed != tuple(
            fleet["launches"]):
        raise AssertionError(f"dp pair fleet: seeds {[res['fleet']['ranks'] for res in ranks]}"
                             f", launches {[res['fleet']['launches'] for res in ranks]} vs "
                             f"{fleet['launches']}")
    log(f"dp pair fleet S=2 bf16 100x5: seed r on rank r, losses and final params (digests) "
        f"bit for bit the single-process fleet's seeds; launches per rank "
        f"{[tuple(res['fleet']['launches']) for res in ranks]}, single process "
        f"{tuple(fleet['launches'])}")
    pre = [res["preempt"] for res in ranks]
    files = sorted(os.listdir(os.path.join(pair_dir, "preempt")))
    want = sorted(f"{k}_pre_0.pkl" for k in ("model", "optimizer", "infos"))
    if pre[0]["iter"] != pre[1]["iter"] or files != want or \
            f"resumes at iter {pre[0]['iter']}" not in texts[0]:
        raise AssertionError(f"dp pair SIGTERM: ranks stopped at {pre}, files {files}")
    log(f"dp pair SIGTERM to rank 1 alone: both ranks stopped after iteration "
        f"{pre[0]['iter'] - 1} and exited 0, {stop_s:.2f} s after the signal; rank 0 wrote "
        f"{files}; launches per rank {[tuple(p['launches']) for p in pre]}")
    shutil.rmtree(pair_dir, ignore_errors=True)
    return out


def mp_pair_check(torch, solo, solo_grads, ranks, pair_dir, card):
    """Phase 15 (b), the dp 1 x mp 2 run of the pair against one process's
    XE run on the same batches (``pair_runs`` without a mesh): losses and
    the first step's gathered grads within PAIR_TOL["xe"] on every leaf
    (the forward up to the logit is one process's on each rank, so its
    switches, the reason heads' amax picks and hinges, are the solo run's);
    the final params and the first step's grads bit for bit on both ranks;
    launches per rank MP_PAIR_LAUNCHES; rank 0's boundary triple the final
    params bit for bit."""
    tol = PAIR_TOL["xe"]
    mp = [r["mp"] for r in ranks]
    for res in mp:
        a, b = res["loss_history"], solo["loss_history"]
        if len(a) != len(b) or not all(abs(x - y) <= tol["atol"] + tol["rtol"] * abs(y)
                                       for x, y in zip(a, b)):
            raise AssertionError(f"mp pair xe: losses {a} vs one process's {b}")
        if tuple(res["launches"]) != MP_PAIR_LAUNCHES:
            raise AssertionError(f"mp pair xe: launches {res['launches']}, expected "
                                 f"{MP_PAIR_LAUNCHES}")
    if len({r["final_digest"] for r in mp}) != 1 or len({r["grads_digest"] for r in mp}) != 1:
        raise AssertionError("mp pair xe: the ranks' final params or first-step grads differ "
                             "(the replicated leaves must match bit for bit)")
    if not mp[0].get("triple_equal"):
        raise AssertionError("mp pair xe: rank 0's boundary triple is not the final params")
    grads = torch.load(os.path.join(pair_dir, "mp_grads.pt"))
    worst, bad, top = grads_apart(grads, solo_grads, lambda path: tol)
    if bad or sorted(grads) != sorted(solo_grads):
        raise AssertionError(f"mp pair xe: first-step grads beyond rtol {tol['rtol']} / atol "
                             f"{tol['atol']} of one process's at {bad}: {top}")
    out = dict(ranks=mp, grads_worst_share=worst, grads_worst_leaves=top, tol=tol)
    log(f"mp pair xe f32 (gloo, dp 1 x mp 2 on cuda:0, 512 rows on each rank, logit "
        f"{mp[0]['shard_shapes']['logit_w']} and embed {mp[0]['shard_shapes']['embed']} a "
        f"rank): losses within rtol {tol['rtol']} / atol {tol['atol']} of one process's "
        f"({mp[0]['loss_history']} vs {solo['loss_history']}); first-step grads gathered, "
        f"{len(grads)} leaves, worst share {worst:.3f} ({top[:2]}); final params and grads "
        f"bit for bit on both ranks; rank 0's triple = the final params bit for bit (read "
        f"{mp[0]['triple_read_s']:.2f} s); step ms per rank "
        f"{[round(r['step_median_ms'], 2) for r in mp]} (one process "
        f"{solo['step_median_ms']:.2f}), of which the mp collectives "
        f"{[round(r['mp_collective_median_ms'], 2) for r in mp]}; peak GB per process "
        f"{[round(r['peak_gb'], 2) for r in mp]}; launches per rank "
        f"{[tuple(r['launches']) for r in mp]} on {card}")
    return out


def dp_nccl_pair(torch, card, root, data_argv):
    """Phase 15 (c): the XE CLI over an NCCL pair across two cards under
    torch.distributed.run, where the machine has two; else None."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"dp NCCL pair across two cards: not run ({n} CUDA device on {card})")
        return None
    log_path = os.path.join(root, "nccl_pair.jsonl")
    wall, _ = run_group(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "recurrent_fusion_network_torch.main", *data_argv, "--num_dp_devices", "2",
         "--dtype", "bfloat16", "--batch_size", "100", "--seq_per_img", "5",
         "--max_iterations", str(DP_XE_STEPS), "--save_checkpoint_every", str(10 ** 6),
         "--losses_log_every", "1", "--json_log", log_path, "--checkpoint_path",
         os.path.join(root, "ck_pair"), "--id", "pair"], 600, "dp NCCL pair")
    step_ms, gaps, _ = event_step_ms(log_path, "train")
    log(f"dp NCCL pair across two cards: XE bf16 100 x 5 (50 a rank), step {step_ms:.2f} ms "
        f"(median of the JSONL gaps), wall {wall:.2f} s on {card}")
    return dict(step_ms=step_ms, gaps_ms=gaps, wall_s=wall)


def phase15(torch, model, card, counters, recorder):
    """Phase 15: data parallelism over torch.distributed on the card. (a)
    NCCL at world size 1 through the CLIs, (b) a gloo pair sharing cuda:0
    against the single-process runs, (c) the numbers, and the NCCL pair
    across two cards where there are two. Every launch's shape goes to
    ``recorder`` under PHASE15_RUNS."""
    import tempfile

    t0 = time.perf_counter()
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    free_gb = shutil.disk_usage(build).free / 1e9
    if free_gb < DP_FREE_GB:
        raise AssertionError(f"dp: {free_gb:.1f} GB free under {build}, {DP_FREE_GB} GB "
                             "needed")
    root = tempfile.mkdtemp(prefix="dp_", dir=build)
    try:
        # its own seed: on phase 8's data the pair's XE step switches nothing
        # (``SwitchSpy``), on this one some amax picks
        data_argv, data_gb = write_driver_dataset(root, model, seed=2)
        log(f"dp: data set of {data_gb:.2f} GB written in {time.perf_counter() - t0:.2f} s")
        out = {"world1": dp_world1(torch, model, card, counters, recorder, root, data_argv)}
        torch.cuda.empty_cache()
        out["pair"] = dp_pair(torch, card, counters, recorder, root, data_argv)
        out["nccl_pair"] = dp_nccl_pair(torch, card, root, data_argv)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {run: recorder.totals(run) for run in PHASE15_RUNS}
    out["seconds"] = time.perf_counter() - t0
    log(f"dp: phase 15 in {out['seconds']:.2f} s; launches (fwd, bwd) by run "
        f"{out['launches']}")
    return out


# ------------------------------------------------------- 16. the device meshes

MESH_DEVICES = ("cuda:0", "cuda:0")  # the mesh's two blocks share the one card
MESH_TIMED = 6  # B = 512 batches timed through pipelined_map, on the mesh and off
MESH_SEEDS = (50, 51)  # the mesh ensemble's two flagship members
DIFF_FEAT_SEED = 60  # member i of the diff-feat ensemble: seed 60 + i
# phase 16's runs and their dtypes
PHASE16_RUNS = {"mesh_serve": "bfloat16", "mesh_ensemble": "float32",
                "diff_feat_ensemble": "float32"}


def mesh_serving(torch, model, card, counters, recorder, solo_rate):
    """Phase 16 (b): one B = 512 beam-3 bf16 batch of 512 requests through a
    CaptionServer on the device mesh MESH_DEVICES (two blocks of 256 rows on
    the one card): tokens identical to the one-device decode of the same
    batch, launches 2 x 64; then the mesh's decode (both blocks queued, then
    read) on B = 512 batches through pipelined_map, captions/s beside the
    one-device decode's in the same way and phase 5's."""
    import numpy as np

    from recurrent_fusion_network_torch.decoding.api import model_sample
    from recurrent_fusion_network_torch.decoding.serve import CaptionServer, pipelined_map
    from recurrent_fusion_network_torch.parallel.mesh import (join_blocks, make_device_mesh,
                                                              replicate, with_dp_sharding)
    from recurrent_fusion_network_torch.training.checkpoint import cast_tree

    t0 = time.perf_counter()
    mesh = make_device_mesh(len(MESH_DEVICES), MESH_DEVICES)
    params = cast_tree(model.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                                         device=DEVICE), torch.bfloat16)
    replicas = replicate(mesh, params)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    batches = [features(torch, model, BATCH, gen, torch.float32) for _ in range(2)]
    fcs, atts = [x.cpu().numpy() for x in batches[0][0]], [x.cpu().numpy() for x in
                                                           batches[0][1]]
    rows = [([f[i] for f in fcs], [a[i] for a in atts]) for i in range(BATCH)]
    batches = [[[x.to(torch.bfloat16) for x in part] for part in b] for b in batches]

    def decode(p, f, a):
        with torch.inference_mode():
            return model_sample(model, p, f, a, beam_size=BEAM).seq

    def decoder(p):
        return lambda f, a: {"seq": decode(p, f, a)}

    # depth 1: the batch is read back as soon as it is decoded (a deeper
    # window waits flush_interval for the next request first); the batch
    # waits for all its 512 requests (the submits take about a second)
    server = CaptionServer([decoder(p) for p in replicas], BATCH, mesh=mesh, depth=1,
                           flush_interval=60.0, cast_dtype=torch.bfloat16)
    try:
        want = decode(params, *batches[0]).cpu().numpy()
        torch.cuda.synchronize()
        reset_counters(counters)
        t1 = time.perf_counter()
        with recorder.run("mesh_serve"):
            futs = [server.submit(f, a) for f, a in rows]
            got = np.stack([fut.result(timeout=600)["seq"] for fut in futs])
        server_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches = read_counters(counters, "mesh serve")
        stats = dict(server.stats)
    finally:
        server.close()
    apart = int((got != want).any(axis=1).sum())
    if apart or launches != (2 * 64, 0) or recorder.totals("mesh_serve") != launches \
            or stats["batches"] != 1:
        raise AssertionError(f"mesh serve: {apart} of {BATCH} rows' tokens differ from the "
                             f"one-device decode's, or launches {launches} (2 x 64), stats "
                             f"{stats}")

    def mesh_decode(batch):
        return [decode(p, *block) for p, block in zip(replicas, with_dp_sharding(mesh, batch))]

    rates = {}
    for name, fn, read in (("mesh", mesh_decode, lambda out: join_blocks(out)),
                           ("one_device", lambda b: decode(params, *b), lambda out: out.cpu())):
        read(fn(batches[1]))  # warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = 0
        for _, out in pipelined_map(fn, (batches[i % 2] for i in range(MESH_TIMED)), depth=2):
            n += read(out).shape[0]
        rates[name] = n / (time.perf_counter() - t1)
    out = dict(rows_apart=apart, launches=launches, server_batch_s=server_s, stats=stats,
               mesh_captions_per_s=rates["mesh"], one_device_captions_per_s=rates["one_device"],
               solo_pipelined_captions_per_s=solo_rate, seconds=time.perf_counter() - t0)
    log(f"mesh serve: CaptionServer B={BATCH} beam 3 bf16 on the mesh {list(MESH_DEVICES)} "
        f"(two blocks of {BATCH // 2} rows): the 512 requests' tokens identical to the "
        f"one-device decode of the same batch; launches {launches} (2 x 64); the batch "
        f"{server_s:.2f} s from the first submit to the last row; stats {stats}. "
        f"{rates['mesh']:.1f} captions/s on the mesh, {rates['one_device']:.1f} on one device "
        f"({MESH_TIMED} B={BATCH} batches each through pipelined_map depth 2), phase 5's "
        f"{solo_rate:.1f}: no speed-up is possible, both blocks share one card; "
        f"{out['seconds']:.2f} s on {card}")
    del params, replicas, batches
    torch.cuda.empty_cache()
    return out


def mesh_loader(model, root):
    """(opt, loader) of phase 8's data set at the eval CLI's shapes: the
    100 test images in one batch of 100 x 5, beam 3, f32."""
    from recurrent_fusion_network_torch.config import parse_opt
    from recurrent_fusion_network_torch.data.build import build_loader

    data_argv, _, _ = driver_data(model)
    opt = parse_opt(data_argv + [
        "--device", DEVICE, "--batch_size", "100", "--seq_per_img", "5", "--beam_size", "3",
        "--val_images_use", "100", "--language_eval", "1", "--id", "mesh",
        "--eval_results_dir", os.path.join(root, "eval_results")])
    loader = build_loader(opt)
    opt.vocab_size, opt.seq_length = loader.vocab_size, loader.seq_length
    return opt, loader


def mesh_ensemble(torch, model, card, counters, recorder, root):
    """Phase 16 (c): eval_ensemble of two flagship f32 members (seeds
    MESH_SEEDS) on phase 8's 100 test images, beam 3, on the mesh
    MESH_DEVICES (two blocks of 50 images) against no mesh: predictions
    identical; launches 2 blocks x 2 members x 64."""
    from recurrent_fusion_network_torch.parallel.mesh import make_device_mesh
    from recurrent_fusion_network_torch.training.eval_ensemble import eval_ensemble

    members = [(model, model.init_params(torch.Generator(device=DEVICE).manual_seed(s),
                                         device=DEVICE)) for s in MESH_SEEDS]
    mesh = make_device_mesh(len(MESH_DEVICES), MESH_DEVICES)
    runs = {}
    for name in ("plain", "mesh"):
        opt, loader = mesh_loader(model, root)
        try:
            torch.cuda.synchronize()
            reset_counters(counters)
            t0 = time.perf_counter()
            with recorder.run("mesh_ensemble") if name == "mesh" else contextlib.nullcontext():
                preds, _ = eval_ensemble(members, loader, opt, split="test",
                                         language_eval_flag=False,
                                         mesh=mesh if name == "mesh" else None)
            torch.cuda.synchronize()
            runs[name] = dict(preds=preds, s=time.perf_counter() - t0,
                              launches=read_counters(counters, f"mesh ensemble {name}"))
        finally:
            loader.close()
    expect = (2 * len(MESH_SEEDS) * 64, 0)
    if runs["mesh"]["preds"] != runs["plain"]["preds"] or len(runs["mesh"]["preds"]) != 100 \
            or runs["mesh"]["launches"] != expect or recorder.totals("mesh_ensemble") != expect:
        raise AssertionError(f"mesh ensemble: predictions differ from no mesh's, or launches "
                             f"{runs['mesh']['launches']} != {expect}")
    log(f"mesh ensemble: 2 flagship f32 members, beam 3, phase 8's 100 test images on the "
        f"mesh {list(MESH_DEVICES)} (two blocks of 50): predictions identical to no mesh's; "
        f"launches {runs['mesh']['launches']} (no mesh {runs['plain']['launches']}); eval "
        f"{runs['mesh']['s']:.2f} s on the mesh, {runs['plain']['s']:.2f} s without, on {card}")
    del members
    torch.cuda.empty_cache()
    return {k: dict(s=r["s"], launches=r["launches"]) for k, r in runs.items()}


def diff_feat_members(torch, model):
    """One ReviewNet per flagship encoder at the published widths (the
    encoder's fc / att widths and regions, E = R = H = 512, 8 review steps,
    1000 top words, tied keys, vocab 9487), random weights from seed
    DIFF_FEAT_SEED + i."""
    from recurrent_fusion_network_torch.models import ReviewNetModel

    out = []
    for i, (fc, att, num) in enumerate(zip(model.fc_feat_sizes, model.att_feat_sizes,
                                           model.att_nums)):
        m = ReviewNetModel(vocab_size=model.vocab_size, seq_length=model.seq_length,
                           input_encoding_size=HID, rnn_size=HID, att_hid_size=HID,
                           fc_feat_size=fc, att_feat_size=att, att_num=num,
                           num_review_steps=8, top_words_count=1000, tied_att_keys=True)
        out.append((m, m.init_params(torch.Generator(device=DEVICE).manual_seed(
            DIFF_FEAT_SEED + i), device=DEVICE)))
    return out


def diff_feat_ensemble(torch, aa, model, card, counters, recorder, root):
    """Phase 16 (d): the diff-feat ensemble (member i reads encoder i's
    features) of five ReviewNets at published widths through
    eval_ensemble(diff_feat=True) on phase 8's 100 test images, one batch,
    beam 3, f32: predictions with the kernels equal those with the plain
    versions, the forward's launches 5 x 24, the 8 metrics finite."""
    from unittest import mock

    from recurrent_fusion_network_torch.ops import attention
    from recurrent_fusion_network_torch.training.eval_ensemble import eval_ensemble

    members = diff_feat_members(torch, model)
    per_batch = sum(model_launches(m)[0] for m, _ in members)
    runs = {}
    for name in ("kernel", "plain"):
        opt, loader = mesh_loader(model, root)
        try:
            torch.cuda.synchronize()
            reset_counters(counters)
            t0 = time.perf_counter()
            with (recorder.run("diff_feat_ensemble") if name == "kernel" else
                  mock.patch.object(attention, "additive_attention",
                                    aa.additive_attention_ref)):
                preds, stats = eval_ensemble(members, loader, opt, split="test",
                                             diff_feat=True,
                                             language_eval_flag=name == "kernel")
            torch.cuda.synchronize()
            runs[name] = dict(preds=preds, stats=stats, s=time.perf_counter() - t0,
                              launches=read_counters(counters, f"diff feat {name}"))
        finally:
            loader.close()
    k = runs["kernel"]
    if k["preds"] != runs["plain"]["preds"] or len(k["preds"]) != 100 \
            or k["launches"] != (per_batch, 0) \
            or recorder.totals("diff_feat_ensemble") != (per_batch, 0) \
            or runs["plain"]["launches"] != (0, 0):
        raise AssertionError(f"diff feat ensemble: predictions differ between the kernels and "
                             f"the plain versions, or launches {k['launches']} / "
                             f"{runs['plain']['launches']} != ({per_batch}, 0) / (0, 0)")
    stats = check_stats(k["stats"], "diff feat ensemble")
    log(f"diff feat ensemble: 5 ReviewNets (one per flagship encoder, published widths), "
        f"beam 3, f32, phase 8's 100 test images: predictions with the kernels equal those "
        f"with the plain versions; launches {k['launches']} ({per_batch} a batch); metrics "
        f"{stats}; eval {k['s']:.2f} s (plain versions {runs['plain']['s']:.2f} s) on {card}")
    del members
    torch.cuda.empty_cache()
    return dict(launches=k["launches"], stats=stats, s=k["s"], plain_s=runs["plain"]["s"])


def phase16(torch, aa, model, card, counters, solo_rate):
    """Phase 16: the device meshes on one card. (b) the serving mesh, (c)
    the ensemble over it, (d) the diff-feat ensemble; ((a), the dp 1 x mp
    2 pair, runs inside phase 15's pair processes). Every launch's shape is
    then checked against the plain versions. -> (results, forward rows)."""
    import tempfile

    t0 = time.perf_counter()
    recorder, parts = ShapeRecorder(aa), {}
    out = {"serve": mesh_serving(torch, model, card, counters, recorder, solo_rate)}
    parts["serve"] = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="mesh_", dir=os.path.join(REPO, "build"))
    try:
        t1 = time.perf_counter()
        out["ensemble"] = mesh_ensemble(torch, model, card, counters, recorder, root)
        parts["ensemble"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["diff_feat"] = diff_feat_ensemble(torch, aa, model, card, counters, recorder, root)
        parts["diff_feat"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t1 = time.perf_counter()
    rows, bwd_rows = check_driver_sites(torch, aa, recorder,
                                        {"mesh": tuple(PHASE16_RUNS)})
    parts["shape_checks"] = time.perf_counter() - t1
    if bwd_rows:
        raise AssertionError("phase 16: a backward launch on an inference path")
    out["launches"] = {run: recorder.totals(run) for run in PHASE16_RUNS}
    out["seconds"], out["parts_s"] = time.perf_counter() - t0, parts
    log(f"meshes: phase 16 in {out['seconds']:.2f} s (by part "
        f"{ {k: round(v, 2) for k, v in parts.items()} }): {len(recorder.fwd)} forward shapes "
        f"checked against the plain versions; launches (fwd, bwd) by run {out['launches']}")
    return out, rows


# ------------------------------------------------ 17. the full-pipeline proxy

PROXY_SEEDS = 2  # the root pipeline_proxy.py's default fleet, at its --quick depth
PROXY_HID = 96  # pipeline_proxy.build_corpus's rnn / att_hid width
# phase 17's runs, the top-level calls of pipeline_proxy.main they time
PROXY_RUNS = {"proxy_xe": "train_multi_seed", "proxy_scst": "train_multi_seed_rl",
              "proxy_test_cider": "test_cider", "proxy_ensemble": "eval_ensemble"}
PROXY_GATES = ("rl_ge_xe_all_seeds", "rl_gt_xe_majority", "scst_advantage_improved",
               "ensemble_gt_single", "rl_params_changed", "rl_gt_xe", "rl_ge_xe")


class StepLaunches:
    """The launches (fwd, bwd) of every call of the proxy's per-step
    functions, by kind: the XE step, the SCST rollout and step, an eval
    batch of eval_split and of eval_ensemble (each kernel is queued inside
    the call that launches it, so the counters' change across a call is
    its launches)."""

    def __init__(self, counters):
        self.counters, self.calls = counters, {}

    def _now(self):
        return (sum(c.launches for c in self.counters),
                sum(c.bwd_launches for c in self.counters))

    def wrap(self, kind, fn):
        def call(*a, **kw):
            f0, b0 = self._now()
            out = fn(*a, **kw)
            f1, b1 = self._now()
            self.calls.setdefault(kind, []).append((f1 - f0, b1 - b0))
            return out

        return call

    def patches(self):
        """The patches that wrap the fleets' step makers and both eval
        loops' dispatch."""
        from unittest import mock

        from recurrent_fusion_network_torch.training import eval_ensemble, eval_split
        from recurrent_fusion_network_torch.training import multi_seed

        make_step, make_rollout = multi_seed.make_train_step, multi_seed.make_rollout_fn
        make_rl_step = multi_seed.make_rl_step

        def rl_step(*a, **kw):
            step, old = make_rl_step(*a, **kw)
            return self.wrap("rl_step", step), old

        def dispatching(module, kind):
            real = module.pipelined_map
            return lambda fn, items, **kw: real(self.wrap(kind, fn), items, **kw)

        return [mock.patch.object(multi_seed, "make_train_step",
                                  lambda *a, **kw: self.wrap("xe_step", make_step(*a, **kw))),
                mock.patch.object(multi_seed, "make_rollout_fn",
                                  lambda *a, **kw: self.wrap("rollout", make_rollout(*a, **kw))),
                mock.patch.object(multi_seed, "make_rl_step", rl_step),
                mock.patch.object(eval_split, "pipelined_map",
                                  dispatching(eval_split, "eval_batch")),
                mock.patch.object(eval_ensemble, "pipelined_map",
                                  dispatching(eval_ensemble, "ensemble_batch"))]


def proxy_launches(model, members):
    """(fwd, bwd) launches of one call of each kind, from the model's
    shape: an encode reads M x S0 (stage I) + S (stage II); a teacher-forced
    forward decodes L + 1 steps, a greedy decode or the rollout (its 2B
    lanes in one pass) L + 1; an eval batch is the loss's forward and the
    greedy decode, an ensemble batch each member's greedy decode."""
    enc = model.num_feat_array * model.num_review_steps_0 + model.num_review_steps
    step = enc + model.seq_length + 1
    return {"xe_step": (step, step), "rollout": (step, 0), "rl_step": (step, step),
            "eval_batch": (2 * step, 0), "ensemble_batch": (members * step, 0)}


def phase17(torch, aa, card, counters):
    """Phase 17: the root pipeline_proxy.py's chain on the port, python -m
    recurrent_fusion_network_torch.pipeline_proxy --quick (PROXY_SEEDS
    seeds, the default untied profile) in this process: an XE fleet, an
    SCST fleet from its best triples (ending at iter rl_iters: a warm start
    counts from 0), the per-seed test CIDEr, the ensemble of the rl_ best
    triples. The launches of every XE step, SCST rollout and step and eval
    batch, each as the model's shape says, adding up to the
    run's; every launch's shape checked against the plain versions; finite
    CIDEr fields, SCST's params moved, the -best and rl_-best triples in
    place; the ordering gates printed as they came out (--quick asserts
    none); the wall seconds by part. -> (results, forward rows, backward
    rows)."""
    import tempfile
    from unittest import mock

    from recurrent_fusion_network_torch import pipeline_proxy

    t0 = time.perf_counter()
    recorder, steps = ShapeRecorder(aa, hid=PROXY_HID), StepLaunches(counters)
    wall, models, scst = {run: 0.0 for run in PROXY_RUNS}, [], {}

    def timed(run, fn):
        def call(*a, **kw):
            t1 = time.perf_counter()
            with recorder.run(run):
                out = fn(*a, **kw)
            torch.cuda.synchronize()
            wall[run] += time.perf_counter() - t1
            if run == "proxy_xe":
                models.append(out["model"])
            if run == "proxy_scst":
                scst.update(iter=out["iter"], epoch=out["epoch"],
                            rewards_at=[sorted(h) for h in out["reward_histories"]])
            return out

        return call

    root = tempfile.mkdtemp(prefix="proxy_", dir=os.path.join(REPO, "build"))
    try:
        work, out_json = os.path.join(root, "work"), os.path.join(root, "proxy.json")
        with contextlib.ExitStack() as stack:
            for p in steps.patches() + [
                    mock.patch.object(pipeline_proxy, name, timed(run, getattr(pipeline_proxy,
                                                                               name)))
                    for run, name in PROXY_RUNS.items()]:
                stack.enter_context(p)
            torch.cuda.synchronize()
            reset_counters(counters)
            t1 = time.perf_counter()
            pipeline_proxy.main(["--quick", "--seeds", str(PROXY_SEEDS), "--device", DEVICE,
                                 "--work_dir", work, "--out", out_json])
            torch.cuda.synchronize()
            wall["main"] = time.perf_counter() - t1
        total = read_counters(counters, "proxy")
        with open(out_json) as f:
            written = json.load(f)
        files = set(os.listdir(work))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    expect = proxy_launches(models[0], PROXY_SEEDS)
    per_kind = {}
    for kind, calls in steps.calls.items():
        if set(calls) != {expect[kind]}:
            raise AssertionError(f"proxy: {kind} launches {sorted(set(calls))}, expected "
                                 f"{expect[kind]} a call")
        per_kind[kind] = dict(calls=len(calls), launches_per_call=expect[kind])
    summed = tuple(sum(n[i] for calls in steps.calls.values() for n in calls) for i in (0, 1))
    by_run = {run: recorder.totals(run) for run in PROXY_RUNS}
    if summed != total or tuple(map(sum, zip(*by_run.values()))) != total \
            or set(per_kind) != set(expect):
        raise AssertionError(f"proxy: the calls' launches {summed} (kinds {sorted(per_kind)}) "
                             f"and the runs' {by_run} do not add up to the run's {total}")
    ciders = written["xe_test_cider"] + written["rl_test_cider"] + [
        written["ensemble_test_cider"]] + written["xe_val_best_per_seed"] + written[
        "rl_val_best_per_seed"]
    if not all(isinstance(c, float) and math.isfinite(c) for c in ciders) \
            or not written["rl_params_changed"] or written["card"] != card \
            or written["tied_att_keys"] or not written["quick"]:
        raise AssertionError(f"proxy: the result {written}")
    best = {f"{prefix}{kind}_proxy_{r}-best.pkl" for prefix in ("", "rl_")
            for kind in ("model", "optimizer", "infos") for r in range(PROXY_SEEDS)}
    if not best <= files:
        raise AssertionError(f"proxy: triples missing {sorted(best - files)}")
    # the SCST fleet counted its warm start from 0, as the JAX fleet does:
    # rl_iters iterations, one rollout each a seed, the rewards from 0
    rl_iters = written["rl_iters"]
    if scst["iter"] != rl_iters or len(steps.calls["rollout"]) != PROXY_SEEDS * rl_iters \
            or any(not h or h[0] != 0 or h[-1] >= rl_iters for h in scst["rewards_at"]):
        raise AssertionError(f"proxy: the SCST fleet ended at {scst}, "
                             f"{len(steps.calls['rollout'])} rollouts; expected iter {rl_iters}")
    gates = {g: written[g] for g in PROXY_GATES}
    log(f"proxy: XE test CIDEr {written['xe_test_cider']}, RL {written['rl_test_cider']}, "
        f"ensemble {written['ensemble_test_cider']}; SCST advantage "
        f"{written['scst_advantage']}; gates as they came out (--quick asserts none): {gates}")
    log(f"proxy: launches (fwd, bwd) {total}, by run {by_run}, per call {per_kind}; the SCST "
        f"fleet ended at iter {scst['iter']} (epoch {scst['epoch']}) of rl_iters {rl_iters}")

    t1 = time.perf_counter()
    rows, bwd_rows = check_driver_sites(torch, aa, recorder, {"proxy": tuple(PROXY_RUNS)})
    shape_s = time.perf_counter() - t1
    out = dict(result={k: v for k, v in written.items() if k != "rl_xe_delta_ci_per_seed"},
               delta_ci=written["rl_xe_delta_ci_per_seed"], gates=gates, per_call=per_kind,
               launches=by_run, wall_s={k: round(v, 2) for k, v in wall.items()},
               scst_end=dict(iter=scst["iter"], epoch=scst["epoch"]),
               shape_check_s=shape_s, seconds=time.perf_counter() - t0)
    log(f"proxy: phase 17 in {out['seconds']:.2f} s: main {wall['main']:.2f} s, of it XE fleet "
        f"{wall['proxy_xe']:.2f}, SCST fleet {wall['proxy_scst']:.2f}, test CIDEr "
        f"{wall['proxy_test_cider']:.2f}, ensemble {wall['proxy_ensemble']:.2f}; "
        f"{len(recorder.fwd)} forward and {len(recorder.bwd)} backward shapes (H = "
        f"{PROXY_HID}) checked against the plain versions in {shape_s:.2f} s; {card}")
    return out, rows, bwd_rows


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

    # ---- 13. the asyncio front end, the greedy-baseline reward, the runbook's
    # dry run
    p13, p13_rows, p13_bwd_rows = phase13(torch, aa, model, card, scorer)
    p13_launches = {"aio_serve": p13["serve"]["asyncio"]["launches"],
                    "threads_serve": p13["serve"]["threads"]["launches"],
                    "sc_reward": p13["sc_reward"]["launches"],
                    **{name: tuple(n) for run, _ in RUNBOOK_RUNS
                       for name, n in p13["runbook"][run]["launches"].items()}}
    p13_fwd = sum(f for f, _ in p13_launches.values())
    p13_bwd = sum(b for _, b in p13_launches.values())
    p13_fwd_sums = {run: dict(path_sums(p13_rows, run), dtype="bfloat16" if run.endswith(
        "_serve") else "float32") for run, (f, _) in p13_launches.items() if f}
    p13_bwd_sums = {run: dict(path_sums(p13_bwd_rows, run), dtype="float32")
                    for run, (_, b) in p13_launches.items() if b}
    if any(p13_fwd_sums[r]["launches"] != f for r, (f, _) in p13_launches.items() if f) or any(
            p13_bwd_sums[r]["launches"] != b for r, (_, b) in p13_launches.items() if b):
        raise AssertionError("phase 13: the checked sites do not add up to its launches")
    torch.cuda.empty_cache()

    # ---- 14. SPICE rewards in SCST and its fleet, orbax (DCP) checkpoints,
    # the --profile_steps trace window
    p14, p14_rows, p14_bwd_rows = phase14(torch, aa, model, card, scorer)
    p14_launches = {"spice_approx": p14["spice"]["approx"]["launches"],
                    "spice_http": p14["spice"]["http"]["launches"],
                    "spice_fleet": p14["spice"]["fleet"]["launches"],
                    **{f"orbax_{m}": p14["orbax"][m]["launches"]
                       for m in ("pickle", "dcp_sync", "dcp_async")},
                    "orbax_eval": p14["orbax"]["eval"]["launches"],
                    "orbax_ensemble": p14["orbax"]["eval_ensemble"]["launches"],
                    "orbax_resume": p14["orbax"]["resume"]["launches"],
                    "trace": p14["trace"]["launches"]}
    p14_fwd = sum(f for f, _ in p14_launches.values())
    p14_bwd = sum(b for _, b in p14_launches.values())
    p14_fwd_sums = {run: dict(path_sums(p14_rows, run), dtype="float32" if run.startswith(
        "spice") else "bfloat16") for run, (f, _) in p14_launches.items() if f}
    p14_bwd_sums = {run: dict(path_sums(p14_bwd_rows, run), dtype="float32" if run.startswith(
        "spice") else "bfloat16") for run, (_, b) in p14_launches.items() if b}
    if any(p14_fwd_sums[r]["launches"] != f for r, (f, _) in p14_launches.items() if f) or any(
            p14_bwd_sums[r]["launches"] != b for r, (_, b) in p14_launches.items() if b):
        raise AssertionError("phase 14: the checked sites do not add up to its launches")
    torch.cuda.empty_cache()

    # ---- 15. data parallelism over torch.distributed: NCCL at world size 1
    # through the CLIs, a gloo pair sharing the card
    p15 = phase15(torch, model, card, [aa], recorder)
    p15_launches = p15.pop("launches")
    p15_fwd = sum(f for f, _ in p15_launches.values())
    p15_bwd = sum(b for _, b in p15_launches.values())
    torch.cuda.empty_cache()

    # ---- 16. the device meshes: the serving mesh, the ensemble over it, the
    # diff-feat ensemble
    p16, p16_rows = phase16(torch, aa, model, card, [aa], solo_rate)
    p16_launches = p16.pop("launches")
    p16_fwd = sum(f for f, _ in p16_launches.values())
    p16_sums = {run: dict(path_sums(p16_rows, run), dtype=PHASE16_RUNS[run])
                for run in p16_launches}
    if any(p16_sums[r]["launches"] != f for r, (f, _) in p16_launches.items()):
        raise AssertionError("phase 16: the checked sites do not add up to its launches")
    torch.cuda.empty_cache()

    # ---- 17. the full-pipeline proxy: XE fleet -> SCST fleet -> ensemble on
    # the learnable corpus
    p17, p17_rows, p17_bwd_rows = phase17(torch, aa, card, [aa])
    p17_launches = p17.pop("launches")
    p17_fwd = sum(f for f, _ in p17_launches.values())
    p17_bwd = sum(b for _, b in p17_launches.values())
    p17_fwd_sums = {run: dict(path_sums(p17_rows, run), dtype="float32")
                    for run, (f, _) in p17_launches.items() if f}
    p17_bwd_sums = {run: dict(path_sums(p17_bwd_rows, run), dtype="float32")
                    for run, (_, b) in p17_launches.items() if b}
    if any(p17_fwd_sums[r]["launches"] != f for r, (f, _) in p17_launches.items() if f) or any(
            p17_bwd_sums[r]["launches"] != b for r, (_, b) in p17_launches.items() if b):
        raise AssertionError("phase 17: the checked sites do not add up to its launches")
    torch.cuda.empty_cache()

    # both kernels against their plain versions at every shape of phases 8,
    # 10, 11 and 15's runs
    t0 = time.perf_counter()
    drv_rows, drv_bwd_rows = check_driver_sites(
        torch, aa, recorder, {"drivers": ("xe", "eval", "scst_overlap_1", "scst_overlap_0"),
                              "fleets": PHASE10_RUNS, "front": ("front_xe", "front_scst"),
                              "dp": tuple(PHASE15_RUNS)})
    log(f"drivers, fleets, data front and data parallelism: {len(recorder.fwd)} forward and "
        f"{len(recorder.bwd)} backward shapes checked against the plain versions in "
        f"{time.perf_counter() - t0:.2f} s")
    p15_fwd_sums = {run: dict(path_sums(drv_rows, run), dtype=PHASE15_RUNS[run])
                    for run, (f, _) in p15_launches.items() if f}
    p15_bwd_sums = {run: dict(path_sums(drv_bwd_rows, run), dtype=PHASE15_RUNS[run])
                    for run, (_, b) in p15_launches.items() if b}
    if (path_sums(drv_rows, "dp")["launches"], path_sums(drv_bwd_rows, "dp")["launches"]) \
            != (p15_fwd, p15_bwd):
        raise AssertionError("data parallelism: the checked sites do not add up to phase "
                             "15's launches")

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
    # twice under flip) and the FLEET_SEEDS-member B = 512 ensemble (5 batches)
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
    rows = rows + scst_rows + drv_rows + rn_rows + raw_rows + p13_rows + p14_rows + p16_rows \
        + p17_rows
    bwd_rows = bwd_rows + scst_bwd_rows + drv_bwd_rows + rn_bwd_rows + p13_bwd_rows \
        + p14_bwd_rows + p17_bwd_rows
    kernels = [{
        "name": "additive_attention_fwd",
        "route": "cuda",
        "source": "recurrent_fusion_network_torch/csrc/additive_attention.cu",
        "replaces": "recurrent_fusion_network_tpu/ops/attention.py:46",
        "launches": launches["additive_attention"]
        + trained["launches"]["additive_attention_fwd"]
        + scst_launches["additive_attention_fwd"] + driver_fwd + sum(model_fwd.values())
        + fleet_fwd + p11_fwd + p12_fwd + p13_fwd + p14_fwd + p15_fwd + p16_fwd + p17_fwd,
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
                             **p12_launches,
                             **{run: f for run, (f, _) in p13_launches.items()},
                             **{run: f for run, (f, _) in p14_launches.items()},
                             **{run: f for run, (f, _) in p15_launches.items()},
                             **{run: f for run, (f, _) in p16_launches.items()},
                             **{run: f for run, (f, _) in p17_launches.items()}},
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
        # --image_folder and /caption_image alike; phase 13: over each whole
        # run (the two front ends' 64 requests, one greedy-baseline reward,
        # each stage of the runbook's dry run); phase 17: over each part of
        # the proxy's run (the XE fleet, the SCST fleet, each with its evals,
        # the test CIDEr of every seed's two best triples, the ensemble)
        "by_path": {"serve": serve, "train": train_fwd, "scst": scst_fwd, "eval": eval_fwd,
                    "drivers": drivers_fwd, **rn_fwd, **fleet_fwd_sums, **remat_fwd,
                    **front_fwd, "raw_image_batch": raw_batch, **p13_fwd_sums,
                    **p14_fwd_sums, **p15_fwd_sums, **p16_sums, **p17_fwd_sums},
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
        + fleet_bwd + p11_bwd + p13_bwd + p14_bwd + p15_bwd + p17_bwd,
        "launches_by_path": {"train": trained["launches"]["additive_attention_bwd"],
                             "scst": scst_launches["additive_attention_bwd"],
                             "drivers": driver_bwd, **model_bwd,
                             "fleet_xe": fleet_launches["fleet_xe"][1],
                             "fleet_scst": fleet_launches["fleet_scst"][1],
                             **{run: b for run, (_, b) in p11_launches.items()},
                             **{run: b for run, (_, b) in p13_launches.items() if b},
                             **{run: b for run, (_, b) in p14_launches.items() if b},
                             **{run: b for run, (_, b) in p15_launches.items() if b},
                             **{run: b for run, (_, b) in p17_launches.items() if b}},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        # errors relative to the largest plain value of each output
        "max_rel_err": max(r["max_rel_err"] for r in bwd_rows),
        # per bf16 train step at B = 512: the sum over its 65 launches
        "ms": train_bwd["ms"],
        "plain_ms": train_bwd["plain_ms"],
        "bound_ms": train_bwd["bound_ms"],
        "by_path": {"train": train_bwd, "scst": scst_bwd, "drivers": drivers_bwd, **rn_bwd,
                    **fleet_bwd_sums, **remat_bwd, **front_bwd, **p13_bwd_sums,
                    **p14_bwd_sums, **p15_bwd_sums, **p17_bwd_sums},
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
    log("phase 13 summary: " + json.dumps(p13))
    log("phase 14 summary: " + json.dumps(p14))
    log("phase 15 summary: " + json.dumps(p15))
    log("phase 16 summary: " + json.dumps(p16))
    log("phase 17 summary: " + json.dumps(p17))
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
    if sys.argv[1:2] == ["--launch-probe"]:
        launch_probe(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["--probe-server"]:
        sys.exit(probe_server(sys.argv[2], sys.argv[3]))
    elif sys.argv[1:2] == ["--dp-pair-rank"]:
        dp_pair_rank(sys.argv[2])
    else:
        main()
