"""Backbone dispatch for extraction, image-folder eval and /caption_image.

Counterpart of ``recurrent_fusion_network_tpu/data/feature_extraction/
backbones.py``.

Precision: the JAX package's backbones compute in f32, and the features
they write feed training. cuDNN would run the port's f32 convolutions in
TF32 by default (``torch.backends.cudnn.allow_tf32``); ``features_fn`` runs
them in full f32 instead (``ALLOW_TF32 = False``), scoped to the backbone
call under a lock, so no other code sees the flag changed.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from ...device import resolve_device
from . import densenet, inception, resnet

ARCHS = (
    "resnet50", "resnet101", "resnet152", "densenet121", "densenet161",
    "inception_v3", "inception_v4", "inception_resnet_v2",
)

ALLOW_TF32 = False  # cuDNN convolutions of the backbones: full f32
_PRECISION = threading.Lock()


@contextlib.contextmanager
def conv_precision():
    """Run the enclosed convolutions with cuDNN's TF32 set to ``ALLOW_TF32``;
    the flag is restored on exit, and callers on other threads wait."""
    with _PRECISION:
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = ALLOW_TF32
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = saved


def trunk(arch: str, att_size: int) -> Tuple[Callable, Dict[str, tuple], int, int]:
    """(raw features function (params, images) -> (fc, att), parameter
    shapes, fc_dim, att_dim) of an arch. fc_dim == att_dim for every arch
    but inception_v3 (fc 2048 at Mixed_7c, att 1280 at Mixed_7a); the
    inception grids are set by the input, and ``att_size`` is not read."""
    if arch.startswith("resnet") and arch in ARCHS:
        cfg = resnet.ResNetConfig(blocks=getattr(resnet.ResNetConfig, arch)().blocks,
                                  att_size=att_size)
        return ((lambda p, imgs: resnet.resnet_features(p, imgs, cfg)),
                resnet.param_shapes(cfg), cfg.width * 32, cfg.width * 32)
    if arch.startswith("densenet") and arch in ARCHS:
        base = getattr(densenet.DenseNetConfig, arch)()
        cfg = densenet.DenseNetConfig(blocks=base.blocks, growth=base.growth,
                                      init_features=base.init_features, att_size=att_size)
        return ((lambda p, imgs: densenet.densenet_features(p, imgs, cfg)),
                densenet.param_shapes(cfg), cfg.out_features, cfg.out_features)
    if arch in inception._TRUNKS:
        _, fc_dim, att_dim = inception._TRUNKS[arch]
        return ((lambda p, imgs: inception.inception_features(arch, p, imgs)),
                inception.param_shapes(arch), fc_dim, att_dim)
    raise ValueError(f"arch not supported: {arch}; choose from {ARCHS}")


def load_weights(arch: str, path: str, shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """A torchvision ``.pth`` state dict (resnet, densenet) or the JAX
    package's flat npz (inception) -> the backbone's parameters."""
    if arch in inception._TRUNKS:
        sd, kind = inception.load_flat_npz(path), "flat-npz"
    else:
        sd, kind = torch.load(path, map_location="cpu", weights_only=True), "torch"
    print(f"loaded {kind} weights from {path}")
    return resnet.pick_state_dict(sd, shapes)


def build_backbone(arch: str, att_size: int, torch_weights: Optional[str] = None,
                   seed: int = 0, device=None):
    """-> (params on ``device``, features_fn(params, images) -> (fc (B, fc_dim),
    att (B, S, S, att_dim)), fc_dim, att_dim). images: (B, H, W, 3) float in
    [0, 1] on the params' device. Without ``torch_weights`` the weights are
    drawn from ``torch.Generator().manual_seed(seed)``. ``features_fn`` runs
    without autograd, its convolutions in full f32 (``conv_precision``)."""
    device = resolve_device(device)
    raw, shapes, fc_dim, att_dim = trunk(arch, att_size)
    if torch_weights:
        params = load_weights(arch, torch_weights, shapes)
    else:
        params = resnet.init_params(shapes, torch.Generator().manual_seed(seed))
        print("WARNING: random backbone weights (smoke run only)")
    params = {k: v.to(device) for k, v in params.items()}

    def features_fn(p, images):
        with torch.inference_mode(), conv_precision():
            return raw(p, images)

    return params, features_fn, fc_dim, att_dim


def output_shapes(features_fn, params, image_size: int):
    """(fc shape, att shape) of one image at ``image_size``: a forward on the
    ``meta`` device, so nothing is computed (``jax.eval_shape``'s job)."""
    meta = {k: torch.empty_like(v, device="meta") for k, v in params.items()}
    fc, att = features_fn(meta, torch.empty(1, image_size, image_size, 3, device="meta"))
    return tuple(fc.shape), tuple(att.shape)
