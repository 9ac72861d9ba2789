"""Ensemble evaluation.

Counterpart of ``recurrent_fusion_network_tpu/training/eval_ensemble.py``
(the reference's eval_ensemble.py and the four ensemble paths of
eval_utils.py: :387 beam, :729 greedy, :1026 / :1183 diff-feat greedy and
beam), in one loop:

  * members: N (model, params) pairs, multi-seed checkpoints of one
    architecture or per-encoder ReviewNets (``diff_feat``: member i reads
    the i-th encoder's features);
  * per decode step the members' logits are averaged
    (``decoding/ensemble.py``);
  * optionally the flip ensemble: decode the original and the flipped
    features of the same images and keep, per image, the sentence with the
    higher log-prob.

The member params go to the device once, cast to bf16 on the host first
under ``--dtype bfloat16``. Each batch's features are deduped to one row
per image on the host before the copy, and batches are dispatched through
``decoding/serve.py::pipelined_map`` with depth 2.

With a ``mesh`` (a ``parallel/mesh.py::DeviceMesh``; JAX
eval_ensemble.py:79-137) every member's params go to every device of it
once, each batch's images are split into one block a device, every block's
decode is queued before any readback, and the blocks' sentences are joined
in order. In a process group of several ranks the mesh is dropped: each
rank decodes its rows alone (JAX :85-86). No CLI flag reaches the mesh, as
in the JAX package; the CLI reads ``--eval_ensemble_multi_gpu`` and ignores
it, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.pinned import batch_feats
from ..data.vocab import decode_sequence
from ..decoding.ensemble import ensemble_sample, flip_combine
from ..decoding.serve import pipelined_map
from ..device import resolve_device
from ..metrics.coco_eval import language_eval
from ..ops.initializers import tree_map
from ..parallel import distributed
from ..parallel.mesh import join_blocks, replicate, with_dp_sharding
from .checkpoint import cast_tree
from .eval_split import default_gts_lookup, eval_dtype, iter_eval_batches, trim_to_budget


def _member_splits(fc1, att1, n_members, diff_feat):
    """Each member's (fc, att): the i-th encoder's under diff_feat, else
    every encoder's."""
    if diff_feat:
        if len(fc1) < n_members:
            raise ValueError(f"a diff_feat ensemble of {n_members} members needs one "
                             f"encoder per member; the batch has {len(fc1)}")
        return [(fc1[i], att1[i]) for i in range(n_members)]
    return [(fc1, att1)] * n_members


def _host(arrays, dtype):
    """Host float32 arrays -> host tensors of ``dtype`` (bf16 halves the
    bytes copied)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype or torch.float32)
            for a in arrays]


def _to_device(arrays, device, dtype):
    """Host float32 arrays -> tensors on ``device``, cast on the host first.
    A CUDA copy goes from page-locked memory (PyTorch's caching host
    allocator) without a sync, so it queues behind the batch in flight."""
    out = []
    for t in _host(arrays, dtype):
        if device.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return out


def _dedupe(data, batch_size, seq_per_img):
    """(fc list, att list) of one row per image, on the host before the
    copy: the loader repeats every image seq_per_img times for the loss,
    which the ensemble does not compute."""
    fc, att = batch_feats(data)
    rows = np.arange(batch_size) * seq_per_img
    return [f[rows] for f in fc], [a[rows] for a in att]


def _variant_feats(loader, data, variant):
    """The same images' features under another augmentation variant, one
    row per image: (fc list, att list) of numpy arrays, one per encoder."""
    fc_batch = [[] for _ in loader.sources]
    att_batch = [[] for _ in loader.sources]
    for info in data["infos"]:
        for m, src in enumerate(loader.sources):
            fc, att = src.load(info["id"], variant)
            fc_batch[m].append(fc)
            att_batch[m].append(att.reshape(-1, att.shape[-1]))
    return ([np.stack(f).astype(np.float32) for f in fc_batch],
            [np.stack(a).astype(np.float32) for a in att_batch])


def eval_ensemble(members: Sequence[Tuple], loader, opt, *, split: str = "test",
                  beam_size: Optional[int] = None, val_images_use: Optional[int] = None,
                  diff_feat: bool = False, flip_ensemble: Optional[bool] = None,
                  language_eval_flag: Optional[bool] = None, gts_lookup=None, rank: int = 0,
                  verbose: bool = False, device=None, mesh=None):
    """Returns (predictions, lang_stats or None), decoding on ``device``
    (default ``opt.device``: CUDA unless "cpu") or over the devices of
    ``mesh``. ``members``: (model, params) pairs, params a tensor tree on
    the host or on ``device``."""
    c = distributed.cluster()
    if mesh is not None and c is not None and c.world > 1:
        mesh = None  # each rank decodes its own rows (JAX :85-86)
    device = resolve_device(getattr(opt, "device", None) if device is None else device)
    beam_size = opt.beam_size if beam_size is None else beam_size
    val_images_use = opt.val_images_use if val_images_use is None else val_images_use
    if flip_ensemble is None:
        flip_ensemble = bool(getattr(opt, "eval_flip_ensemble", 0))
    if language_eval_flag is None:
        language_eval_flag = bool(opt.language_eval)

    models = [m for m, _ in members]
    dtype = eval_dtype(opt)
    # --dtype bfloat16 halves the members' residency: cast on the host,
    # then every member's params cross to the device once for all batches
    host_params = [cast_tree(p, dtype) if dtype is not None else p for _, p in members]
    if mesh is None:
        params_list = [tree_map(lambda t: t.to(device), p) for p in host_params]
    else:  # every member on every device: one list of members a device
        params_list = [list(per) for per in zip(*(replicate(mesh, p) for p in host_params))]

    @torch.inference_mode()
    def decode(fc, att):
        """Queue the decode of one batch's images (host arrays, one per
        encoder); device tensors out, a list of the blocks' on a mesh."""
        if mesh is None:
            return ensemble_sample(models, params_list, _member_splits(
                _to_device(fc, device, dtype), _to_device(att, device, dtype), len(members),
                diff_feat), beam_size=beam_size)
        blocks = with_dp_sharding(mesh, (_host(fc, dtype), _host(att, dtype)))
        return [ensemble_sample(models, ps, _member_splits(f, a, len(members), diff_feat),
                                beam_size=beam_size)
                for ps, (f, a) in zip(params_list, blocks)]

    def dispatch(data):
        """Queue the decode(s) of one batch."""
        out_a = decode(*_dedupe(data, loader.batch_size, loader.seq_per_img))
        if not flip_ensemble:
            return out_a, None
        # the same images under the flip variant (the iterator does not move)
        return out_a, decode(*_variant_feats(loader, data, "flip"))

    def joined(out):
        return out if mesh is None or out is None else join_blocks(out)

    loader.reset_iterator(split)
    vocab = loader.get_vocab()
    predictions = []
    batches = iter_eval_batches(loader, split, val_images_use,
                                variant="original" if flip_ensemble else None)
    for data, (out_a, out_b) in pipelined_map(dispatch, batches, depth=2):
        out_a, out_b = joined(out_a), joined(out_b)
        seq = flip_combine(out_a, out_b)[0] if flip_ensemble else out_a.seq.cpu().numpy()
        for k, sent in enumerate(decode_sequence(vocab, seq)):
            predictions.append({"image_id": data["infos"][k]["id"], "caption": sent})
        if verbose:
            b = data["bounds"]
            print(f"ensemble {split} ... {b['it_pos_now']}/{b['it_max']}")

    predictions = trim_to_budget(predictions, loader, split, val_images_use)
    lang_stats = None
    if language_eval_flag and predictions:
        lang_stats = language_eval(
            gts_lookup or default_gts_lookup(loader), predictions,
            f"ensemble_{opt.id}_{rank}", split,
            out_dir=getattr(opt, "eval_results_dir", "eval_results"))
    return predictions, lang_stats
