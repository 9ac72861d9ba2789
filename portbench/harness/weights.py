"""Weights from the seed, made on the device in one draw.

Every leaf is U(-s, s): s = 0.1 (the port's and the reference
implementation's INITRANGE) for all leaves but the output projection's
weight, which takes s = 0.5 so that the logits spread as a trained
captioner's do (a few units) and the beam's choices are not near-ties.
The layout (leaf names and shapes) is the model's own; the values are the
benchmark's, and the same values go to the port and to the reference.
"""

from __future__ import annotations

import torch

from .env import sub_seed
from .trees import leaves_with_paths, rebuild

INITRANGE = 0.1
LOGIT_RANGE = 0.5


def leaf_range(path) -> float:
    return LOGIT_RANGE if tuple(path[-2:]) == ("logit", "w") else INITRANGE


def make_weights(layout, seed: int, device, dtype=torch.float32):
    """``layout``: a tree of tensors whose shapes are taken (meta tensors
    will do). -> the same tree of ``dtype`` tensors on ``device``. f32
    leaves are views of one flat buffer drawn in one call."""
    items = leaves_with_paths(layout)
    total = sum(x.numel() for _, x in items)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0)
    out, off = [], 0
    for path, x in items:
        n = x.numel()
        leaf = flat[off:off + n].view(x.shape).mul_(leaf_range(path))
        out.append(leaf if dtype == torch.float32 else leaf.to(dtype))
        off += n
    return rebuild(layout, out)


def count(layout) -> int:
    return sum(x.numel() for _, x in leaves_with_paths(layout))
