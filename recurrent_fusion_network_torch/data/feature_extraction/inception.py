"""Inception-V3 / Inception-V4 / Inception-ResNet-V2 feature backbones.

Counterpart of ``recurrent_fusion_network_tpu/data/feature_extraction/
inception_jax.py``, with the reference's modified TF-slim nets' taps:

  V3  : att = Mixed_7a output (1280 @ 8x8), fc = global mean of Mixed_7c (2048)
  V4  : att = the last Inception-C output (1536 @ 8x8), fc = its mean (1536)
  IRv2: att = Conv2d_7b_1x1 output (1536 @ 8x8), fc = its mean (1536)

at the canonical 299 x 299 input. Parameters are a flat dict keyed by the
slim names (``Mixed_5b/Branch_0/Conv2d_0a_1x1/w``, ``.../bn/{scale,bias,
mean,var}``), conv weights OIHW; ``load_flat_npz`` reads the JAX package's
npz files (weights HWIO there). ``conv_bn`` is slim.conv2d: a conv without
bias, batch norm with eps 1e-3, ReLU; ``(name, x, filters, kh, kw)``, so a
``1x7`` conv has kh = 1, kw = 7. Stride-1 SAME convs (odd kernels) pad
symmetrically; every stride-2 conv and every max pool is VALID; the 3x3
stride-1 SAME average pool divides by the in-bounds count.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .resnet import init_params


class ParamBuilder:
    """Reads the slim-named parameters as the trunk asks for them; with no
    parameters, records each conv's and batch norm's shape instead (run on
    the ``meta`` device: ``param_shapes``)."""

    def __init__(self, params: Optional[Dict] = None):
        self.params = params
        self.shapes: Dict[str, tuple] = {}
        self._scope = []

    @contextlib.contextmanager
    def scope(self, name):
        self._scope.append(name)
        try:
            yield
        finally:
            self._scope.pop()

    def _get(self, leaf, shape, like):
        name = "/".join(self._scope + [leaf])
        if self.params is None:
            self.shapes[name] = tuple(shape)
            return torch.empty(shape, dtype=like.dtype, device=like.device)
        return self.params[name]

    def conv_bn(self, name, x, filters, kh, kw=None, stride=1, padding="SAME", relu=True):
        """slim.conv2d: conv (no bias) + batch norm (eps 1e-3) + ReLU."""
        kw = kh if kw is None else kw
        if padding == "SAME":
            if stride != 1 or kh % 2 == 0 or kw % 2 == 0:
                raise ValueError(f"{name}: SAME padding is symmetric only for stride 1 and "
                                 f"odd kernels")
            pad = ((kh - 1) // 2, (kw - 1) // 2)
        else:
            pad = 0
        with self.scope(name):
            w = self._get("w", (filters, x.shape[1], kh, kw), x)
            x = F.conv2d(x, w, stride=stride, padding=pad)
            scale, bias, mean, var = (self._get(f"bn/{leaf}", (filters,), x)
                                      for leaf in ("scale", "bias", "mean", "var"))
            x = F.batch_norm(x, mean, var, scale, bias, training=False, eps=1e-3)
        return torch.relu(x) if relu else x


def max_pool(x):
    """3x3 stride-2 VALID max pool."""
    return F.max_pool2d(x, 3, 2)


def avg_pool(x):
    """3x3 stride-1 SAME average pool over the in-bounds pixels."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def _preprocess(images):
    """slim inception preprocessing: [0, 1] -> [-1, 1]; NHWC -> NCHW."""
    return (images * 2.0 - 1.0).permute(0, 3, 1, 2)


def _cat(*xs):
    return torch.cat(xs, dim=1)


# =========================================================== Inception-V3


def _v3_trunk(x, pb: ParamBuilder):
    c = pb.conv_bn
    x = c("Conv2d_1a_3x3", x, 32, 3, stride=2, padding="VALID")
    x = c("Conv2d_2a_3x3", x, 32, 3, padding="VALID")
    x = c("Conv2d_2b_3x3", x, 64, 3)
    x = max_pool(x)
    x = c("Conv2d_3b_1x1", x, 80, 1, padding="VALID")
    x = c("Conv2d_4a_3x3", x, 192, 3, padding="VALID")
    x = max_pool(x)

    def mixed_5(name, x, pool_proj):
        with pb.scope(name):
            b0 = c("Branch_0/Conv2d_0a_1x1", x, 64, 1)
            b1 = c("Branch_1/Conv2d_0a_1x1", x, 48, 1)
            b1 = c("Branch_1/Conv2d_0b_5x5", b1, 64, 5)
            b2 = c("Branch_2/Conv2d_0a_1x1", x, 64, 1)
            b2 = c("Branch_2/Conv2d_0b_3x3", b2, 96, 3)
            b2 = c("Branch_2/Conv2d_0c_3x3", b2, 96, 3)
            b3 = c("Branch_3/Conv2d_0b_1x1", avg_pool(x), pool_proj, 1)
            return _cat(b0, b1, b2, b3)

    x = mixed_5("Mixed_5b", x, 32)
    x = mixed_5("Mixed_5c", x, 64)
    x = mixed_5("Mixed_5d", x, 64)

    with pb.scope("Mixed_6a"):
        b0 = c("Branch_0/Conv2d_1a_1x1", x, 384, 3, stride=2, padding="VALID")
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 64, 1)
        b1 = c("Branch_1/Conv2d_0b_3x3", b1, 96, 3)
        b1 = c("Branch_1/Conv2d_1a_1x1", b1, 96, 3, stride=2, padding="VALID")
        x = _cat(b0, b1, max_pool(x))  # 768

    def mixed_6(name, x, mid):
        with pb.scope(name):
            b0 = c("Branch_0/Conv2d_0a_1x1", x, 192, 1)
            b1 = c("Branch_1/Conv2d_0a_1x1", x, mid, 1)
            b1 = c("Branch_1/Conv2d_0b_1x7", b1, mid, 1, 7)
            b1 = c("Branch_1/Conv2d_0c_7x1", b1, 192, 7, 1)
            b2 = c("Branch_2/Conv2d_0a_1x1", x, mid, 1)
            b2 = c("Branch_2/Conv2d_0b_7x1", b2, mid, 7, 1)
            b2 = c("Branch_2/Conv2d_0c_1x7", b2, mid, 1, 7)
            b2 = c("Branch_2/Conv2d_0d_7x1", b2, mid, 7, 1)
            b2 = c("Branch_2/Conv2d_0e_1x7", b2, 192, 1, 7)
            b3 = c("Branch_3/Conv2d_0b_1x1", avg_pool(x), 192, 1)
            return _cat(b0, b1, b2, b3)

    for name, mid in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                      ("Mixed_6e", 192)):
        x = mixed_6(name, x, mid)

    with pb.scope("Mixed_7a"):
        b0 = c("Branch_0/Conv2d_0a_1x1", x, 192, 1)
        b0 = c("Branch_0/Conv2d_1a_3x3", b0, 320, 3, stride=2, padding="VALID")
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 192, 1)
        b1 = c("Branch_1/Conv2d_0b_1x7", b1, 192, 1, 7)
        b1 = c("Branch_1/Conv2d_0c_7x1", b1, 192, 7, 1)
        b1 = c("Branch_1/Conv2d_1a_3x3", b1, 192, 3, stride=2, padding="VALID")
        x = _cat(b0, b1, max_pool(x))  # 1280
    att = x

    def mixed_7(name, x):
        with pb.scope(name):
            b0 = c("Branch_0/Conv2d_0a_1x1", x, 320, 1)
            b1 = c("Branch_1/Conv2d_0a_1x1", x, 384, 1)
            b1 = _cat(c("Branch_1/Conv2d_0b_1x3", b1, 384, 1, 3),
                      c("Branch_1/Conv2d_0c_3x1", b1, 384, 3, 1))
            b2 = c("Branch_2/Conv2d_0a_1x1", x, 448, 1)
            b2 = c("Branch_2/Conv2d_0b_3x3", b2, 384, 3)
            b2 = _cat(c("Branch_2/Conv2d_0c_1x3", b2, 384, 1, 3),
                      c("Branch_2/Conv2d_0d_3x1", b2, 384, 3, 1))
            b3 = c("Branch_3/Conv2d_0b_1x1", avg_pool(x), 192, 1)
            return _cat(b0, b1, b2, b3)  # 2048

    x = mixed_7("Mixed_7b", x)
    x = mixed_7("Mixed_7c", x)
    return att, x


# =========================================================== Inception-V4


def _v4_block_a(x, pb, name):
    c = pb.conv_bn
    with pb.scope(name):
        b0 = c("Branch_0/Conv2d_0a_1x1", x, 96, 1)
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 64, 1)
        b1 = c("Branch_1/Conv2d_0b_3x3", b1, 96, 3)
        b2 = c("Branch_2/Conv2d_0a_1x1", x, 64, 1)
        b2 = c("Branch_2/Conv2d_0b_3x3", b2, 96, 3)
        b2 = c("Branch_2/Conv2d_0c_3x3", b2, 96, 3)
        b3 = c("Branch_3/Conv2d_0b_1x1", avg_pool(x), 96, 1)
        return _cat(b0, b1, b2, b3)  # 384


def _v4_block_b(x, pb, name):
    c = pb.conv_bn
    with pb.scope(name):
        b0 = c("Branch_0/Conv2d_0a_1x1", x, 384, 1)
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 192, 1)
        b1 = c("Branch_1/Conv2d_0b_1x7", b1, 224, 1, 7)
        b1 = c("Branch_1/Conv2d_0c_7x1", b1, 256, 7, 1)
        b2 = c("Branch_2/Conv2d_0a_1x1", x, 192, 1)
        b2 = c("Branch_2/Conv2d_0b_7x1", b2, 192, 7, 1)
        b2 = c("Branch_2/Conv2d_0c_1x7", b2, 224, 1, 7)
        b2 = c("Branch_2/Conv2d_0d_7x1", b2, 224, 7, 1)
        b2 = c("Branch_2/Conv2d_0e_1x7", b2, 256, 1, 7)
        b3 = c("Branch_3/Conv2d_0b_1x1", avg_pool(x), 128, 1)
        return _cat(b0, b1, b2, b3)  # 1024


def _v4_block_c(x, pb, name):
    c = pb.conv_bn
    with pb.scope(name):
        b0 = c("Branch_0/Conv2d_0a_1x1", x, 256, 1)
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 384, 1)
        b1 = _cat(c("Branch_1/Conv2d_0b_1x3", b1, 256, 1, 3),
                  c("Branch_1/Conv2d_0c_3x1", b1, 256, 3, 1))
        b2 = c("Branch_2/Conv2d_0a_1x1", x, 384, 1)
        b2 = c("Branch_2/Conv2d_0b_3x1", b2, 448, 3, 1)
        b2 = c("Branch_2/Conv2d_0c_1x3", b2, 512, 1, 3)
        b2 = _cat(c("Branch_2/Conv2d_0d_1x3", b2, 256, 1, 3),
                  c("Branch_2/Conv2d_0e_3x1", b2, 256, 3, 1))
        b3 = c("Branch_3/Conv2d_0b_1x1", avg_pool(x), 256, 1)
        return _cat(b0, b1, b2, b3)  # 1536


def _v4_trunk(x, pb: ParamBuilder):
    c = pb.conv_bn
    x = c("Conv2d_1a_3x3", x, 32, 3, stride=2, padding="VALID")
    x = c("Conv2d_2a_3x3", x, 32, 3, padding="VALID")
    x = c("Conv2d_2b_3x3", x, 64, 3)
    with pb.scope("Mixed_3a"):
        x = _cat(max_pool(x), c("Branch_1/Conv2d_0a_3x3", x, 96, 3, stride=2,
                                padding="VALID"))
    with pb.scope("Mixed_4a"):
        b0 = c("Branch_0/Conv2d_0a_1x1", x, 64, 1)
        b0 = c("Branch_0/Conv2d_1a_3x3", b0, 96, 3, padding="VALID")
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 64, 1)
        b1 = c("Branch_1/Conv2d_0b_1x7", b1, 64, 1, 7)
        b1 = c("Branch_1/Conv2d_0c_7x1", b1, 64, 7, 1)
        b1 = c("Branch_1/Conv2d_1a_3x3", b1, 96, 3, padding="VALID")
        x = _cat(b0, b1)
    with pb.scope("Mixed_5a"):
        x = _cat(c("Branch_0/Conv2d_1a_3x3", x, 192, 3, stride=2, padding="VALID"),
                 max_pool(x))  # 384

    for i in range(4):
        x = _v4_block_a(x, pb, f"Mixed_5{'bcde'[i]}")
    with pb.scope("Mixed_6a"):  # reduction A (k=192 l=224 m=256 n=384)
        b0 = c("Branch_0/Conv2d_1a_3x3", x, 384, 3, stride=2, padding="VALID")
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 192, 1)
        b1 = c("Branch_1/Conv2d_0b_3x3", b1, 224, 3)
        b1 = c("Branch_1/Conv2d_1a_3x3", b1, 256, 3, stride=2, padding="VALID")
        x = _cat(b0, b1, max_pool(x))  # 1024
    for i in range(7):
        x = _v4_block_b(x, pb, f"Mixed_6{'bcdefgh'[i]}")
    with pb.scope("Mixed_7a"):  # reduction B
        b0 = c("Branch_0/Conv2d_0a_1x1", x, 192, 1)
        b0 = c("Branch_0/Conv2d_1a_3x3", b0, 192, 3, stride=2, padding="VALID")
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 256, 1)
        b1 = c("Branch_1/Conv2d_0b_1x7", b1, 256, 1, 7)
        b1 = c("Branch_1/Conv2d_0c_7x1", b1, 320, 7, 1)
        b1 = c("Branch_1/Conv2d_1a_3x3", b1, 320, 3, stride=2, padding="VALID")
        x = _cat(b0, b1, max_pool(x))  # 1536
    for i in range(3):
        x = _v4_block_c(x, pb, f"Mixed_7{'bcd'[i]}")
    return x, x  # att tap == final net (nets/inception_v4.py:309-316)


# ==================================================== Inception-ResNet-V2


def _irv2_trunk(x, pb: ParamBuilder):
    c = pb.conv_bn
    x = c("Conv2d_1a_3x3", x, 32, 3, stride=2, padding="VALID")
    x = c("Conv2d_2a_3x3", x, 32, 3, padding="VALID")
    x = c("Conv2d_2b_3x3", x, 64, 3)
    x = max_pool(x)
    x = c("Conv2d_3b_1x1", x, 80, 1, padding="VALID")
    x = c("Conv2d_4a_3x3", x, 192, 3, padding="VALID")
    x = max_pool(x)

    with pb.scope("Mixed_5b"):
        b0 = c("Branch_0/Conv2d_1x1", x, 96, 1)
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 48, 1)
        b1 = c("Branch_1/Conv2d_0b_5x5", b1, 64, 5)
        b2 = c("Branch_2/Conv2d_0a_1x1", x, 64, 1)
        b2 = c("Branch_2/Conv2d_0b_3x3", b2, 96, 3)
        b2 = c("Branch_2/Conv2d_0c_3x3", b2, 96, 3)
        b3 = c("Branch_3/Conv2d_0b_1x1", avg_pool(x), 64, 1)
        x = _cat(b0, b1, b2, b3)  # 320

    def block35(name, x, scale=0.17):
        with pb.scope(name):
            b0 = c("Branch_0/Conv2d_1x1", x, 32, 1)
            b1 = c("Branch_1/Conv2d_0a_1x1", x, 32, 1)
            b1 = c("Branch_1/Conv2d_0b_3x3", b1, 32, 3)
            b2 = c("Branch_2/Conv2d_0a_1x1", x, 32, 1)
            b2 = c("Branch_2/Conv2d_0b_3x3", b2, 48, 3)
            b2 = c("Branch_2/Conv2d_0c_3x3", b2, 64, 3)
            up = c("Conv2d_1x1", _cat(b0, b1, b2), x.shape[1], 1, relu=False)
            return torch.relu(x + scale * up)

    for i in range(10):
        x = block35(f"Repeat/block35_{i + 1}", x)

    with pb.scope("Mixed_6a"):
        b0 = c("Branch_0/Conv2d_1a_3x3", x, 384, 3, stride=2, padding="VALID")
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 256, 1)
        b1 = c("Branch_1/Conv2d_0b_3x3", b1, 256, 3)
        b1 = c("Branch_1/Conv2d_1a_3x3", b1, 384, 3, stride=2, padding="VALID")
        x = _cat(b0, b1, max_pool(x))  # 1088

    def block17(name, x, scale=0.10):
        with pb.scope(name):
            b0 = c("Branch_0/Conv2d_1x1", x, 192, 1)
            b1 = c("Branch_1/Conv2d_0a_1x1", x, 128, 1)
            b1 = c("Branch_1/Conv2d_0b_1x7", b1, 160, 1, 7)
            b1 = c("Branch_1/Conv2d_0c_7x1", b1, 192, 7, 1)
            up = c("Conv2d_1x1", _cat(b0, b1), x.shape[1], 1, relu=False)
            return torch.relu(x + scale * up)

    for i in range(20):
        x = block17(f"Repeat_1/block17_{i + 1}", x)

    with pb.scope("Mixed_7a"):
        b0 = c("Branch_0/Conv2d_0a_1x1", x, 256, 1)
        b0 = c("Branch_0/Conv2d_1a_3x3", b0, 384, 3, stride=2, padding="VALID")
        b1 = c("Branch_1/Conv2d_0a_1x1", x, 256, 1)
        b1 = c("Branch_1/Conv2d_1a_3x3", b1, 288, 3, stride=2, padding="VALID")
        b2 = c("Branch_2/Conv2d_0a_1x1", x, 256, 1)
        b2 = c("Branch_2/Conv2d_0b_3x3", b2, 288, 3)
        b2 = c("Branch_2/Conv2d_1a_3x3", b2, 320, 3, stride=2, padding="VALID")
        x = _cat(b0, b1, b2, max_pool(x))  # 2080

    def block8(name, x, scale=0.20, relu=True):
        with pb.scope(name):
            b0 = c("Branch_0/Conv2d_1x1", x, 192, 1)
            b1 = c("Branch_1/Conv2d_0a_1x1", x, 192, 1)
            b1 = c("Branch_1/Conv2d_0b_1x3", b1, 224, 1, 3)
            b1 = c("Branch_1/Conv2d_0c_3x1", b1, 256, 3, 1)
            up = c("Conv2d_1x1", _cat(b0, b1), x.shape[1], 1, relu=False)
            x = x + scale * up
            return torch.relu(x) if relu else x

    for i in range(9):
        x = block8(f"Repeat_2/block8_{i + 1}", x)
    x = block8("Block8", x, scale=1.0, relu=False)
    x = c("Conv2d_7b_1x1", x, 1536, 1)
    return x, x  # att tap == Conv2d_7b_1x1 (nets/inception_resnet_v2.py:254-255)


_TRUNKS = {
    "inception_v3": (_v3_trunk, 2048, 1280),
    "inception_v4": (_v4_trunk, 1536, 1536),
    "inception_resnet_v2": (_irv2_trunk, 1536, 1536),
}


@functools.lru_cache(maxsize=None)
def _shapes(arch: str):
    trunk, _, _ = _TRUNKS[arch]
    pb = ParamBuilder()
    trunk(_preprocess(torch.empty(1, 299, 299, 3, device="meta")), pb)
    return tuple(pb.shapes.items())


def param_shapes(arch: str) -> Dict[str, tuple]:
    """{slim name: shape (OIHW for conv weights)} of every parameter the
    trunk reads, in the order it reads them (one trace on the meta device)."""
    return dict(_shapes(arch))


def inception_init(arch: str, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    return init_params(param_shapes(arch), generator)


def inception_features(arch: str, params: Dict, images):
    """images (B, H, W, 3) in [0, 1] (299 -> an 8 x 8 grid) ->
    (fc (B, fc_dim), att (B, S, S, att_dim))."""
    trunk, _, _ = _TRUNKS[arch]
    att, final = trunk(_preprocess(images), ParamBuilder(params))
    return final.mean(dim=(2, 3)), att.permute(0, 2, 3, 1)


def load_flat_npz(path: str) -> Dict[str, torch.Tensor]:
    """The JAX package's flat {slim name: array} npz (converted offline from
    a TF-slim checkpoint; conv weights HWIO) -> this module's parameters,
    conv weights OIHW."""
    z = np.load(path)
    return {k: torch.from_numpy(np.ascontiguousarray(
        z[k].transpose(3, 2, 0, 1) if k.endswith("/w") else z[k])).to(torch.float32)
        for k in z.files}
