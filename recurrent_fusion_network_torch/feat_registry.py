"""Encoder feature descriptions.

The port's own copy of ``EncoderInfo`` from
``recurrent_fusion_network_tpu/feat_registry.py``: checkpoints trained on
real features pickle their ``opt.feat_array_info`` as EncoderInfo objects,
and the port's checkpoint loader rebuilds them as this class. It is a
read-only mapping of the feature sizes, so model factories read
``info["fc_feat_size"]`` alike from it and from the plain dicts of
synthetic checkpoints. The feature-directory lookups of the JAX class
arrive with the port's data loading.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class EncoderInfo(Mapping):
    """Static description of one CNN encoder's precomputed features."""

    name: str
    fc_feat_size: int
    att_feat_size: int
    att_num: int
    data_root: str = "data/features"  # part of the pickled state

    _KEYS = ("name", "fc_feat_size", "att_feat_size", "att_num")

    def __getitem__(self, key):
        if key not in self._KEYS:
            raise KeyError(key)
        return getattr(self, key)

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)
