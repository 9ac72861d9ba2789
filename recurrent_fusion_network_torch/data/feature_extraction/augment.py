"""The 10 augmentation variants, batched.

Counterpart of ``recurrent_fusion_network_tpu/data/feature_extraction/
augment.py``: the reference's horizontal flip and its
``tf.image.crop_and_resize`` 90 % corner boxes (top_right [0.0,0.1,0.9,1.0],
top_left [0.0,0.0,0.9,0.9], bottom_right [0.1,0.1,1.0,1.0], bottom_left
[0.1,0.0,1.0,0.9]), composed on the fly. The JAX package builds each image's
variant in a Python loop; here one call takes a whole (B, H, W, C) batch
(or one (H, W, C) image) and gives the same values.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...feat_registry import VARIANTS

# normalized (y1, x1, y2, x2) boxes, reference generate_crop_images.py:18-27
VARIANT_BOXES: Dict[str, tuple] = {
    "crop_tr": (0.0, 0.1, 0.9, 1.0),
    "crop_tl": (0.0, 0.0, 0.9, 0.9),
    "crop_br": (0.1, 0.1, 1.0, 1.0),
    "crop_bl": (0.1, 0.0, 1.0, 0.9),
}


def _sample_coords(lo, hi, extent, n, device):
    """tf.image.crop_and_resize's grid along one axis: n f32 points
    corner-aligned on [lo*(extent-1), hi*(extent-1)] (the box corners map
    onto the output corners); a single point samples the box centre."""
    if n > 1:
        step = (hi - lo) * (extent - 1) / (n - 1)
        return lo * (extent - 1) + torch.arange(n, dtype=torch.float32, device=device) * step
    return torch.full((1,), 0.5 * (lo + hi) * (extent - 1), dtype=torch.float32,
                      device=device)


def crop_and_resize(img: torch.Tensor, box) -> torch.Tensor:
    """img: (..., H, W, C) float; crop the normalized box and resize back to
    (H, W) with tf.image.crop_and_resize single-box bilinear sampling on the
    corner-aligned fractional grid over [y1*(H-1), y2*(H-1)] x
    [x1*(W-1), x2*(W-1)] (not ``F.interpolate``, not ``roi_align``)."""
    H, W = img.shape[-3], img.shape[-2]
    y1, x1, y2, x2 = box
    ys = _sample_coords(y1, y2, H, H, img.device)
    xs = _sample_coords(x1, x2, W, W, img.device)
    y0 = ys.floor().to(torch.int64).clamp(0, H - 1)
    x0 = xs.floor().to(torch.int64).clamp(0, W - 1)
    y1i = (y0 + 1).clamp(0, H - 1)
    x1i = (x0 + 1).clamp(0, W - 1)
    wy = (ys - y0).to(img.dtype)[:, None, None]
    wx = (xs - x0).to(img.dtype)[None, :, None]
    rows0, rows1 = img.index_select(-3, y0), img.index_select(-3, y1i)
    top = rows0.index_select(-2, x0) * (1 - wx) + rows0.index_select(-2, x1i) * wx
    bot = rows1.index_select(-2, x0) * (1 - wx) + rows1.index_select(-2, x1i) * wx
    return top * (1 - wy) + bot * wy


def make_variant(img: torch.Tensor, variant: str) -> torch.Tensor:
    """One variant of (..., H, W, C) images: the flip variants flip, then
    crop (``flip_crop_*``)."""
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if variant == "original":
        return img
    out = torch.flip(img, dims=(-2,)) if variant.startswith("flip") else img
    box_key = variant.replace("flip_", "")
    if box_key != "flip":
        out = crop_and_resize(out, VARIANT_BOXES[box_key])
    return out


def make_variants(img: torch.Tensor, variants=VARIANTS) -> Dict[str, torch.Tensor]:
    """{variant: images} for the requested variants."""
    return {v: make_variant(img, v) for v in variants}
