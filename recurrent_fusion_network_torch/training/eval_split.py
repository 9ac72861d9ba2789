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
``opt.seed`` per call, batches in order.
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
    """Trim predictions to the image budget, dropping the duplicates of a
    batch that wrapped past the split's end."""
    limit = len(loader.split_image_id[split])
    if val_images_use > 0:
        limit = min(limit, val_images_use)
    return predictions[:limit]


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
               gts_lookup=None, rank=0, verbose=False, device=None):
    """Returns (mean_loss, predictions, lang_stats or None), on
    ``device`` (default ``opt.device``: CUDA unless "cpu")."""
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

    @torch.inference_mode()
    def dispatch(data):
        """Queue the loss and the decode of one batch; device tensors out."""
        fc, att, labels, masks, top_words = device_batch(data, device, dtype)
        lps, reason = model.forward(params, fc, att, labels)
        loss = crit(lps, labels, masks, reason, top_words)
        fc1, att1 = dedupe_feats(fc, att, loader.batch_size, loader.seq_per_img)
        return loss, model_sample(model, params, fc1, att1, beam_size=beam_size,
                                  sample_max=sample_max, generator=generator)

    loader.reset_iterator(split)
    loss_sum, loss_evals = 0.0, 0
    predictions = []
    vocab = loader.get_vocab()
    batches = iter_eval_batches(loader, split, val_images_use)
    for data, (loss_dev, out) in pipelined_map(dispatch, batches, depth=2):
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
