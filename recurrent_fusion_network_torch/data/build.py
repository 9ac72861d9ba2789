"""Construct a DataLoader from opt (file-backed or synthetic).

The port's copy of ``recurrent_fusion_network_tpu/data/build.py``. Feature
backend per encoder, in order:
  1. the sharded columnar store at {data_root}/{encoder}/sharded/
     (``data/sharded.py``, read through the native gather);
  2. packed consolidated arrays at {data_root}/{encoder}/packed/;
  3. reference-compatible per-image file dirs from the registry paths;
  4. feature_type == 'synthetic' (or a plain dict entry): deterministic
     random features (smoke runs), one source per entry of
     feat_array_info (the JAX package keeps the first only, which the
     fusion model cannot run on).
A store whose geometry differs from the registry's raises ValueError. The
loader is never sharded across hosts (ROADMAP.md queue 1, M10).
"""

from __future__ import annotations

import os

from ..feat_registry import VARIANTS
from .dataset import Dataset, DirFeatureSource, PackedFeatureSource, SyntheticFeatureSource
from .loader import DataLoader


def _check_dims(src, info, root: str):
    """A discovered store must match the registry geometry the model is
    built from: a store extracted at another attention grid would otherwise
    feed a model configured for the registry's, failing (if at all) as an
    opaque shape error deep in the model."""
    got = (src.fc_dim, src.att_num, src.att_dim) if hasattr(src, "fc_dim") else src.dims()
    want = (info["fc_feat_size"], info["att_num"], info["att_feat_size"])
    if tuple(got) != tuple(want):
        raise ValueError(
            f"feature store at {root} has (fc_dim, att_num, att_dim)={got} "
            f"but the registry declares {want} for encoder '{info['name']}' — "
            "re-extract with the encoder's native geometry")
    return src


def _source_for(info, data_root: str, seed: int = 0):
    name = getattr(info, "name", "")
    sharded = os.path.join(data_root, name, "sharded")
    if name and os.path.exists(os.path.join(sharded, "manifest.json")):
        from .sharded import ShardedFeatureSource

        return _check_dims(ShardedFeatureSource(sharded), info, sharded)
    packed = os.path.join(data_root, name, "packed")
    if name and os.path.isdir(packed):
        return _check_dims(PackedFeatureSource(packed), info, packed)
    if hasattr(info, "variant_dirs"):
        return DirFeatureSource({v: info.variant_dirs(v) for v in VARIANTS})
    # plain dict entry (tests / synthetic)
    return SyntheticFeatureSource(info["fc_feat_size"], info["att_num"],
                                  info["att_feat_size"], seed=seed)


def build_loader(opt, *, prefetch: bool = True, synthetic: bool = False) -> DataLoader:
    if (synthetic or opt.feature_type == "synthetic") and not os.path.exists(opt.input_json):
        # files-free smoke run: in-memory learnable corpus
        from .synthetic import synthetic_dataset

        dataset = synthetic_dataset(seed=opt.seed, correlated=True)
    else:
        dataset = Dataset.from_files(opt.input_json, opt.input_label_h5, opt.top_words_path,
                                     opt.top_words_count)
    feats = opt.feat_array_info
    if not feats:
        raise ValueError("opt.feat_array_info is empty; set feature_type")
    if synthetic or opt.feature_type == "synthetic":
        sources = [SyntheticFeatureSource(f["fc_feat_size"], f["att_num"], f["att_feat_size"],
                                          seed=opt.seed + i)
                   for i, f in enumerate(feats)]
    else:
        sources = [_source_for(f, opt.data_root, seed=opt.seed + i) for i, f in enumerate(feats)]
    if opt.feature_type not in ("feat_array", "synthetic"):
        sources = sources[:1]  # one registry encoder
    return DataLoader(opt, dataset, sources, prefetch=prefetch)
