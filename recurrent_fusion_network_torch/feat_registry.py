"""Encoder feature registry.

The port's own copy of ``recurrent_fusion_network_tpu/feat_registry.py``:
per CNN encoder, the fc-feature width, the spatial (attention) feature
width, the number of spatial positions, and the on-disk location of each of
the 10 augmentation variants, derived from one ``data_root``:

  resnet               fc 2048  att 2048 x 196
  inception_v4         fc 1536  att 1536 x  64
  inception_v3         fc 2048  att 1280 x  64
  densenet             fc 2208  att 2208 x  49
  inception_resnet_v2  fc 1536  att 1536 x  64

Checkpoints pickle ``opt.feat_array_info`` as EncoderInfo objects. The
port's checkpoint loader rebuilds the JAX package's class as this one, and
its writer pickles this one under the JAX class path
(``training/checkpoint.py``), so either package reads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Mapping

# the reference dataloader's augmentation variants, in its order
VARIANTS = (
    "original",
    "flip",
    "crop_tr",
    "crop_tl",
    "crop_bl",
    "crop_br",
    "flip_crop_tr",
    "flip_crop_tl",
    "flip_crop_bl",
    "flip_crop_br",
)


@dataclasses.dataclass(frozen=True)
class EncoderInfo(Mapping):
    """Static description of one CNN encoder's precomputed features: a
    read-only mapping of the scalar keys and the 10 variant keys
    (``info["fc_feat_size"]``, ``info["original"]["fc"]``)."""

    name: str
    fc_feat_size: int
    att_feat_size: int
    att_num: int
    data_root: str = "data/features"

    def variant_dirs(self, variant: str) -> Dict[str, str]:
        if variant not in VARIANTS:
            raise KeyError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
        base = os.path.join(self.data_root, self.name, variant)
        return {"fc": os.path.join(base, "fc"), "att": os.path.join(base, "att")}

    _SCALAR_KEYS = ("name", "fc_feat_size", "att_feat_size", "att_num")

    def __getitem__(self, key):
        if key in self._SCALAR_KEYS:
            return getattr(self, key)
        return self.variant_dirs(key)

    def __iter__(self):
        yield from self._SCALAR_KEYS
        yield from VARIANTS

    def __len__(self):
        return len(self._SCALAR_KEYS) + len(VARIANTS)


def _make(name: str, fc: int, att: int, num: int, data_root: str) -> EncoderInfo:
    return EncoderInfo(name=name, fc_feat_size=fc, att_feat_size=att, att_num=num,
                       data_root=data_root)


def resnet_info(data_root: str = "data/features") -> EncoderInfo:
    return _make("resnet", 2048, 2048, 196, data_root)


def inception_v4_info(data_root: str = "data/features") -> EncoderInfo:
    return _make("inception_v4", 1536, 1536, 64, data_root)


def inception_v3_info(data_root: str = "data/features") -> EncoderInfo:
    return _make("inception_v3", 2048, 1280, 64, data_root)


def densenet_info(data_root: str = "data/features") -> EncoderInfo:
    return _make("densenet", 2208, 2208, 49, data_root)


def inception_resnet_v2_info(data_root: str = "data/features") -> EncoderInfo:
    return _make("inception_resnet_v2", 1536, 1536, 64, data_root)


_BUILDERS = {
    "resnet": resnet_info,
    "inception_v4": inception_v4_info,
    "inception_v3": inception_v3_info,
    "densenet": densenet_info,
    "inception_resnet_v2": inception_resnet_v2_info,
}


def encoder_info(name: str, data_root: str = "data/features") -> EncoderInfo:
    """Look up one encoder by name."""
    if name not in _BUILDERS:
        raise KeyError(f"feature_type not supported: {name}")
    return _BUILDERS[name](data_root)


def feat_array_info(data_root: str = "data/features") -> List[EncoderInfo]:
    """The 5-encoder fusion array, in the reference's order."""
    return [resnet_info(data_root), inception_v4_info(data_root),
            inception_v3_info(data_root), densenet_info(data_root),
            inception_resnet_v2_info(data_root)]
