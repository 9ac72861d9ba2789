"""Validation / test evaluation harness.

Counterpart of ``recurrent_fusion_network_tpu/training/eval_split.py`` (the
reference's eval_utils.eval_split, eval_utils.py:66-265): per batch the
teacher-forced XE loss (``make_criterion``) and a greedy, multinomial or
beam decode (``decoding/api.py::model_sample``) of the features deduped to
one row per image, then sentence decoding, prediction trimming to the
evaluated image budget and the language metrics (``metrics/coco_eval.py``).

Batches go through ``decoding/serve.py::pipelined_map`` with depth 2: the
next batch's copy and kernels are queued while the current batch's loss and
tokens are read back. Under ``--dtype bfloat16`` the params and features
are cast to bf16 (the criterion's log-softmax stays f32). Multinomial eval
(``sample_max=False``) draws from one ``torch.Generator`` seeded with
``opt.seed`` per call, batches in order. On a loader sharded over
data-parallel ranks each rank decodes and scores its block of every batch,
and the budget is the global one (JAX eval_split.py:177-188): a rank may
keep fewer images than another, or none; the caller weighs the ranks'
scores by their image counts (``parallel/distributed.py::host_mean``).

With a single-process ``mesh`` (``parallel/mesh.py::DeviceMesh``; JAX
eval_split.py:177-222) each batch is split into one block of images a
device, the params replicated once a device: the loss is the mean of the
blocks' (each a mean over equal rows), the sentences the blocks' in order;
multinomial draws come from a generator a block (seed + block), so they
differ from the unsplit batch's. In a process group of several ranks the
mesh is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.pinned import device_batch
from ..data.vocab import decode_sequence
from ..decoding.api import model_sample
from ..decoding.serve import pipelined_map
from ..device import resolve_device
from ..metrics.coco_eval import language_eval
from ..parallel import distributed
from ..parallel.mesh import join_blocks, replicate, with_dp_sharding
from .checkpoint import cast_tree
from .criterion import make_criterion


def eval_dtype(opt):
    """torch.bfloat16 under --dtype bfloat16, else None (f32)."""
    return torch.bfloat16 if getattr(opt, "dtype", "float32") == "bfloat16" else None


def dedupe_feats(fc, att, batch_size, seq_per_img):
    """One row per image of the loader's seq_per_img-repeated features
    (contiguous copies)."""
    rows = torch.arange(batch_size, device=fc[0].device) * seq_per_img
    return [f.index_select(0, rows) for f in fc], [a.index_select(0, rows) for a in att]


def iter_eval_batches(loader, split, val_images_use, *, variant=None):
    """Eval batch stream: stops at the epoch wrap or once val_images_use
    images were produced (batch_size counts IMAGES; each contributes
    seq_per_img label rows)."""
    n = 0
    while True:
        data = loader.get_batch(split, variant=variant) if variant else loader.get_batch(split)
        n += loader.batch_size
        yield data
        if data["bounds"]["wrapped"]:
            return
        if val_images_use > 0 and n >= val_images_use:
            return


def trim_to_budget(predictions, loader, split, val_images_use):
    """Trim predictions to the GLOBAL image budget, dropping the duplicates
    of a batch that wrapped past the split's end. ``predictions`` are this
    rank's rows, batch by batch; on a sharded loader each global batch
    holds the ranks' blocks in rank order, so local row k of batch b is
    global image b * batch_size + rank * local images + k."""
    limit = len(loader.split_image_id[split])
    if val_images_use > 0:
        limit = min(limit, val_images_use)
    hc = getattr(loader, "host_count", 1)
    if hc <= 1:
        return predictions[:limit]
    n_local = loader.batch_size // hc
    base = loader.host_index * n_local
    return [p for pos, p in enumerate(predictions)
            if (pos // n_local) * loader.batch_size + base + pos % n_local < limit]


def default_gts_lookup(loader):
    """image_id -> reference sentences: the raw annotation sentences of the
    info JSON (the reference's coco-caption protocol), else the decoded
    label matrix (seq_length-truncated and UNK-substituted, so absolute
    scores are not the reference's, though best-checkpoint gating works)."""
    ds = loader.dataset
    vocab = loader.get_vocab()

    def gts_lookup(image_id):
        raw = ds.raw_sentences_for_image(image_id)
        if raw:
            return raw
        if image_id not in ds.image_id_to_index:
            return []
        return decode_sequence(vocab, ds.captions_for_image(image_id))

    return gts_lookup


def eval_split(model, params, loader, opt, *, split="val", val_images_use=None,
               beam_size=None, language_eval_flag=None, sample_max=True,
               gts_lookup=None, rank=0, verbose=False, device=None, mesh=None):
    """Returns (mean_loss, predictions, lang_stats or None), on
    ``device`` (default ``opt.device``: CUDA unless "cpu") or over the
    devices of ``mesh``."""
    c = distributed.cluster()
    if mesh is not None and c is not None and c.world > 1:
        mesh = None  # per-rank local eval (JAX :177-178)
    device = resolve_device(getattr(opt, "device", None) if device is None else device)
    val_images_use = opt.val_images_use if val_images_use is None else val_images_use
    beam_size = opt.beam_size if beam_size is None else beam_size
    if language_eval_flag is None:
        language_eval_flag = bool(opt.language_eval)
    dtype = eval_dtype(opt)
    if dtype is not None:
        params = cast_tree(params, dtype)
    crit = make_criterion(opt)
    generator = torch.Generator(device=device).manual_seed(getattr(opt, "seed", 0) or 0)
    # a sharded loader's batches hold this rank's block of images
    local_bs = loader.batch_size // getattr(loader, "host_count", 1)

    def run(params, batch, n_images, generator):
        fc, att, labels, masks, top_words = batch
        lps, reason = model.forward(params, fc, att, labels)
        loss = crit(lps, labels, masks, reason, top_words)
        fc1, att1 = dedupe_feats(fc, att, n_images, loader.seq_per_img)
        return loss, model_sample(model, params, fc1, att1, beam_size=beam_size,
                                  sample_max=sample_max, generator=generator)

    if mesh is not None:
        replicas = replicate(mesh, params)
        generators = [torch.Generator(device=d).manual_seed(
            (getattr(opt, "seed", 0) or 0) + k) for k, d in enumerate(mesh.devices)]

    @torch.inference_mode()
    def dispatch(data):
        """Queue the loss and the decode of one batch; device tensors out."""
        if mesh is None:
            return run(params, device_batch(data, device, dtype), local_bs, generator)
        blocks = with_dp_sharding(mesh, device_batch(data, "cpu", dtype))
        outs = [run(p, b, local_bs // mesh.dp, g)
                for p, b, g in zip(replicas, blocks, generators)]
        return [loss for loss, _ in outs], [out for _, out in outs]

    loader.reset_iterator(split)
    loss_sum, loss_evals = 0.0, 0
    predictions = []
    vocab = loader.get_vocab()
    batches = iter_eval_batches(loader, split, val_images_use)
    for data, (loss_dev, out) in pipelined_map(dispatch, batches, depth=2):
        if mesh is not None:  # the blocks' mean loss and rows in order
            loss_dev, out = sum(float(x) for x in loss_dev) / mesh.dp, join_blocks(out)
        loss = float(loss_dev)
        loss_sum += loss
        loss_evals += 1
        sents = decode_sequence(vocab, out.seq.cpu().numpy())
        for k, sent in enumerate(sents):
            image_id = data["infos"][k]["id"]
            predictions.append({"image_id": image_id, "caption": sent})
            if getattr(opt, "print_beam_candidate", 0) and out.top_seq is not None:
                # every surviving beam, best first (eval_utils.py:225-226)
                cands = decode_sequence(vocab, out.top_seq[k].cpu().numpy())
                for cand, p in zip(cands, out.top_p[k].float().cpu().numpy()):
                    if p > -1e29:
                        print(f"{image_id}\t{p:.3f}\t{cand}")
            if getattr(opt, "print_top_words", 0) and out.reason_preds:
                # top-10 predicted discriminative words per reason head
                # (eval_utils.py:227-237)
                for h, head in enumerate(out.reason_preds):
                    idx = np.argsort(-head[k].float().cpu().numpy())[:10]
                    words = " ".join(loader.top_words[i] for i in idx
                                     if i < len(loader.top_words))
                    print(f"{image_id}_{h}\t{words}")
        if verbose:
            b = data["bounds"]
            print(f"evaluating {split} ... {b['it_pos_now']}/{b['it_max']} loss={loss:.3f}")

    predictions = trim_to_budget(predictions, loader, split, val_images_use)
    lang_stats = None
    if language_eval_flag and predictions:
        lang_stats = language_eval(
            gts_lookup or default_gts_lookup(loader), predictions,
            f"eval_split_{opt.id}_{rank}", split,
            out_dir=getattr(opt, "eval_results_dir", "eval_results"))
    return loss_sum / max(loss_evals, 1), predictions, lang_stats
