"""Caption a folder of raw images end to end.

Counterpart of ``recurrent_fusion_network_tpu/training/eval_folder.py``
(the reference's --image_folder eval mode, opts.py:227-230): the backbone
extracts CNN features on the device (``data/feature_extraction``) and the
captioner decodes them, with no precomputed feature files.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..data.feature_extraction.backbones import build_backbone
from ..data.feature_extraction.extract import image_id_from_name, list_images, load_batch
from ..data.vocab import decode_sequence
from ..decoding.api import model_sample
from ..device import resolve_device


def eval_image_folder(
    model,
    params,
    vocab,
    image_folder: str,
    *,
    beam_size: int = 3,
    batch_size: int = 16,
    image_size: int = 448,
    backbone_arch: str = "resnet101",
    backbone_weights: Optional[str] = None,
    att_size: int = 14,
    device=None,
) -> List[dict]:
    """Returns [{'image_id', 'file', 'caption'}] for every image in the
    folder. ``params``: the captioner's tensors on ``device``."""
    # one backbone feeds one encoder: a multi-encoder RecurrentFusionModel is
    # refused here; an M == 1 one takes the stream wrapped in a list
    wrap = hasattr(model, "fc_feat_sizes")
    if wrap and len(model.fc_feat_sizes) > 1:
        raise ValueError(
            f"--image_folder extracts ONE backbone's features, but this "
            f"{type(model).__name__} expects {len(model.fc_feat_sizes)} "
            f"encoder streams — precompute per-encoder features and use "
            f"the standard eval path instead"
        )
    device = resolve_device(device)
    bb_params, feats_fn, _, _ = build_backbone(backbone_arch, att_size, backbone_weights,
                                               device=device)
    names = list_images(image_folder)
    out = []
    for start in range(0, len(names), batch_size):
        chunk = names[start: start + batch_size]
        fc, att = feats_fn(bb_params, load_batch(image_folder, chunk, image_size, device))
        att = att.reshape(att.shape[0], -1, att.shape[-1])
        if wrap:
            fc, att = [fc], [att]
        with torch.inference_mode():
            seq = model_sample(model, params, fc, att, beam_size=beam_size).seq
        for name, sent in zip(chunk, decode_sequence(vocab, seq.cpu())):
            try:
                image_id = image_id_from_name(name)
            except ValueError:
                image_id = name
            out.append({"image_id": image_id, "file": name, "caption": sent})
    return out
