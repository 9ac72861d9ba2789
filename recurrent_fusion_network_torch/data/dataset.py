"""Dataset bundle + feature-storage backends.

The port's copy of ``recurrent_fusion_network_tpu/data/dataset.py``. The
reference stores one ``{image_id}.npy`` (fc) / ``{image_id}.npz`` (att)
file per image per encoder per augmentation variant (dataloader.py:15-29).
That layout is supported for compatibility (``DirFeatureSource``), but the
default is ``PackedFeatureSource``: one memory-mapped consolidated array per
(encoder, variant), indexed by row. ``SyntheticFeatureSource`` generates
deterministic features from the image id for tests and smoke runs.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np


# reference flip_type integer -> variant name (dataloader.py:432-443 with the
# branch order at :463-543: 0 origin, 1 flip, 2 crop_tr, 3 flip_crop_tr,
# 4 crop_tl, 5 flip_crop_tl, 6 crop_bl, 7 flip_crop_bl, 8 crop_br,
# 9 flip_crop_br)
FLIP_TYPE_TO_VARIANT = (
    "original",
    "flip",
    "crop_tr",
    "flip_crop_tr",
    "crop_tl",
    "flip_crop_tl",
    "crop_bl",
    "flip_crop_bl",
    "crop_br",
    "flip_crop_br",
)


class DirFeatureSource:
    """Reference-compatible per-image-file layout.

    variant_dirs: mapping variant -> {"fc": dir, "att": dir}; fc files are
    ``{id}.npy``, att files are ``{id}.npz`` with key 'feat'
    (dataloader.py:15-18).
    """

    def __init__(self, variant_dirs: Dict[str, Dict[str, str]]):
        self.variant_dirs = variant_dirs

    def load(self, image_id, variant: str = "original"):
        d = self.variant_dirs[variant]
        fc = np.load(os.path.join(d["fc"], f"{image_id}.npy"))
        att = np.load(os.path.join(d["att"], f"{image_id}.npz"))["feat"]
        return fc, att


class PackedFeatureSource:
    """Consolidated memory-mapped feature arrays.

    Layout under `root`:
      ids.json                   — list of image ids (row order)
      {variant}_fc.npy           — (N, fc_dim) float32
      {variant}_att.npy          — (N, att_num, att_dim) float32
    """

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "ids.json")) as f:
            ids = json.load(f)
        self.row = {image_id: i for i, image_id in enumerate(ids)}
        self._fc: Dict[str, np.ndarray] = {}
        self._att: Dict[str, np.ndarray] = {}

    def _arrays(self, variant):
        if variant not in self._fc:
            self._fc[variant] = np.load(
                os.path.join(self.root, f"{variant}_fc.npy"), mmap_mode="r"
            )
            self._att[variant] = np.load(
                os.path.join(self.root, f"{variant}_att.npy"), mmap_mode="r"
            )
        return self._fc[variant], self._att[variant]

    def load(self, image_id, variant: str = "original"):
        fc, att = self._arrays(variant)
        r = self.row[image_id]
        return np.asarray(fc[r]), np.asarray(att[r])

    def dims(self):
        """(fc_dim, att_num, att_dim) from any present variant's arrays
        (mmap header reads only) — lets callers validate a store's geometry
        against the encoder registry before wiring it to a model."""
        import glob

        fcs = sorted(glob.glob(os.path.join(self.root, "*_fc.npy")))
        if not fcs:
            raise FileNotFoundError(f"no *_fc.npy arrays under {self.root}")
        variant = os.path.basename(fcs[0])[: -len("_fc.npy")]
        fc, att = self._arrays(variant)
        return int(fc.shape[1]), int(att.shape[1]), int(att.shape[2])

    @staticmethod
    def write(root, ids, fc_by_variant, att_by_variant):
        """Create a packed source on disk from in-memory arrays."""
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "ids.json"), "w") as f:
            json.dump(list(ids), f)
        for v, arr in fc_by_variant.items():
            np.save(os.path.join(root, f"{v}_fc.npy"), np.asarray(arr, np.float32))
        for v, arr in att_by_variant.items():
            np.save(os.path.join(root, f"{v}_att.npy"), np.asarray(arr, np.float32))
        return PackedFeatureSource(root)


def stable_feature_seed(image_id, variant: str, seed: int) -> int:
    """Process-independent RNG seed for per-(image, variant) features.
    Python's hash() on str-containing tuples is salted per process
    (PYTHONHASHSEED), which silently made synthetic runs unreproducible
    across invocations and across cluster workers."""
    import zlib

    return (
        int(image_id) * 2654435761 + zlib.crc32(variant.encode()) * 97 + seed
    ) % (2**31)


class SyntheticFeatureSource:
    """Deterministic per-id random features (tests / smoke runs)."""

    def __init__(self, fc_dim: int, att_num: int, att_dim: int, seed: int = 0):
        self.fc_dim, self.att_num, self.att_dim, self.seed = fc_dim, att_num, att_dim, seed

    def load(self, image_id, variant: str = "original"):
        g = np.random.default_rng(
            stable_feature_seed(image_id, variant, self.seed)
        )
        fc = g.standard_normal(self.fc_dim).astype(np.float32)
        att = g.standard_normal((self.att_num, self.att_dim)).astype(np.float32)
        return fc, att


class Dataset:
    """Vocab + labels + splits + top-words: everything get_batch needs besides
    features. Mirrors the artifacts of scripts/prepro_labels.py:150-172
    (cocotalk.json + label matrix with 1-based start/end pointers) and the
    top-words pickle consumed at dataloader.py:122-127."""

    def __init__(
        self,
        info: dict,
        labels: np.ndarray,
        label_start_ix: np.ndarray,
        label_end_ix: np.ndarray,
        top_words: Sequence[str],
    ):
        self.info = info
        self.ix_to_word: Dict[str, str] = info["ix_to_word"]
        self.vocab_size = len(self.ix_to_word)
        self.labels = np.asarray(labels)
        self.seq_length = self.labels.shape[1]
        self.label_start_ix = np.asarray(label_start_ix)
        self.label_end_ix = np.asarray(label_end_ix)
        self.top_words = list(top_words)

        self.word_to_ix = {w: int(i) for i, w in self.ix_to_word.items()}
        self.image_id_to_index = {}
        for ix, img in enumerate(info["images"]):
            assert img["id"] not in self.image_id_to_index
            self.image_id_to_index[img["id"]] = ix

        # vectorized vocab-id -> top-word-id map (replaces the reference's
        # per-word string lookups at dataloader.py:321-332)
        word_to_top = {w: i for i, w in enumerate(self.top_words)}
        self.vocab_ix_to_top_ix = np.full(self.vocab_size + 1, -1, dtype=np.int32)
        for i, w in self.ix_to_word.items():
            if w in word_to_top:
                self.vocab_ix_to_top_ix[int(i)] = word_to_top[w]

    # ------------------------------------------------------------------- I/O

    @classmethod
    def from_files(cls, input_json: str, input_label: str, top_words_path: Optional[str] = None,
                   top_words_count: int = 1000):
        with open(input_json) as f:
            info = json.load(f)
        if input_label.endswith(".h5"):
            import h5py

            with h5py.File(input_label, "r") as h5:
                labels = h5["labels"][:]
                start = h5["label_start_ix"][:]
                end = h5["label_end_ix"][:]
        else:
            z = np.load(input_label)
            labels, start, end = z["labels"], z["label_start_ix"], z["label_end_ix"]
        top_words: List[str] = []
        if top_words_path and os.path.exists(top_words_path):
            with open(top_words_path, "rb") as f:
                top_words = pickle.load(f)["words"][:top_words_count]
        return cls(info, labels, start, end, top_words)

    def splits(self, train_only: bool = False, online_training: bool = False):
        """split -> [image_id]; restval joins train unless train_only
        (dataloader.py:160-174)."""
        out = {"train": [], "val": [], "test": []}
        for img in self.info["images"]:
            s = img["split"]
            if s in out:
                out[s].append(img["id"])
            elif not train_only:  # restval
                out["train"].append(img["id"])
        if online_training:
            out["train"] = out["train"] + out["test"]
        return out

    def captions_for_image(self, image_id) -> np.ndarray:
        ix = self.image_id_to_index[image_id]
        i1 = self.label_start_ix[ix] - 1
        i2 = self.label_end_ix[ix]
        return self.labels[i1:i2]

    def raw_sentences_for_image(self, image_id) -> Optional[List[str]]:
        """Untruncated reference sentences from the info JSON, when the
        prepro step recorded them ('raw_sentences'); None otherwise. This is
        the gts source matching the reference's coco-caption protocol, which
        scores against annotation text rather than the seq_length-truncated
        UNK-substituted label matrix."""
        if image_id not in self.image_id_to_index:
            return None
        img = self.info["images"][self.image_id_to_index[image_id]]
        return img.get("raw_sentences")
