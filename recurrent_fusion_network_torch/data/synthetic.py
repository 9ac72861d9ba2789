"""Synthetic COCO-like fixture.

The port's copy of ``recurrent_fusion_network_tpu/data/synthetic.py``: a
tiny deterministic dataset with per-image caption sets, top-word targets,
and one SyntheticFeatureSource per encoder — enough to exercise every
training / eval path end-to-end without COCO files. The same seed gives the
JAX package's dataset and batches.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import Options
from .dataset import Dataset, SyntheticFeatureSource
from .loader import DataLoader

WORDS = (
    "a the man woman dog cat ball park street red blue green small large "
    "sitting standing running holding wearing riding table chair tree sky "
    "grass water food plate bike car sign window door hat shirt".split()
)


def synthetic_dataset(
    n_train: int = 24,
    n_val: int = 8,
    n_test: int = 8,
    seq_length: int = 8,
    caps_per_image: int = 5,
    vocab_words: Optional[List[str]] = None,
    top_words_count: int = 12,
    seed: int = 0,
    correlated: bool = False,
    diversity: float = 0.0,
) -> Dataset:
    """correlated=True makes each image's captions near-copies of one base
    caption of SORTED distinct tokens (order recoverable from content) — a
    fixture with real learnable signal for training-dynamics tests.

    diversity>0 (correlated mode only) drops each base token from captions
    1..k-1 with that probability (caption 0 stays the full base). This
    creates the likelihood/metric mismatch SCST exploits on COCO: the
    references disagree on content, so the maximum-likelihood decode differs
    from the consensus-n-gram (CIDEr-optimal) decode and reward optimization
    has headroom above converged XE."""
    g = np.random.default_rng(seed)
    vocab = list(vocab_words or WORDS)
    V = len(vocab)
    ix_to_word = {str(i + 1): w for i, w in enumerate(vocab)}

    n = n_train + n_val + n_test
    images, labels, starts, ends = [], [], [], []
    row = 0
    for i in range(n):
        split = "train" if i < n_train else ("val" if i < n_train + n_val else "test")
        image_id = 1000 + i
        img = {"id": image_id, "split": split, "file_path": f"img/{image_id}.jpg",
               "raw_sentences": []}
        images.append(img)
        starts.append(row + 1)  # 1-based like the reference
        if correlated:
            # clamp so tiny fixtures (seq_length < 4 or vocab < 16 words)
            # still generate instead of hitting an empty integers() range
            hi = max(1, min(seq_length, V // 4))
            lo = min(4, hi)
            ln = int(g.integers(lo, hi + 1))
            base = np.sort(g.choice(np.arange(1, V + 1), size=ln, replace=False))
        for c in range(caps_per_image):
            cap = np.zeros(seq_length, dtype=np.int64)
            if correlated:
                toks = base.copy()
                if c > 0 and diversity > 0:
                    # random token drops, sorted order kept, >=3 survivors
                    keep = g.random(len(toks)) >= diversity
                    if keep.sum() < min(3, len(toks)):
                        keep[: min(3, len(toks))] = True
                    toks = toks[keep]
                elif c > 0:  # one-token perturbation, re-sorted
                    toks[int(g.integers(0, ln))] = int(g.integers(1, V + 1))
                    toks = np.sort(np.unique(toks))
                cap[: len(toks)] = toks
            else:
                ln = int(g.integers(3, seq_length + 1))
                cap[:ln] = g.integers(1, V + 1, ln)
            img["raw_sentences"].append(
                " ".join(ix_to_word[str(t)] for t in cap if t > 0)
            )
            labels.append(cap)
            row += 1
        ends.append(row)

    info = {"ix_to_word": ix_to_word, "images": images}
    top_words = vocab[:top_words_count]
    return Dataset(info, np.stack(labels), np.array(starts), np.array(ends), top_words)


class LearnableFeatureSource:
    """Features that ENCODE the image's caption content: a bag-of-words
    embedding of the image's first caption plus small noise. A captioner
    trained on this fixture must learn a real feature->text mapping, so
    learning-dynamics tests (XE loss down => CIDEr up; SCST reward up) have
    actual signal — unlike SyntheticFeatureSource's pure noise."""

    def __init__(self, dataset: "Dataset", fc_dim: int, att_num: int, att_dim: int,
                 seed: int = 0, noise: float = 0.05):
        self.ds = dataset
        self.fc_dim, self.att_num, self.att_dim = fc_dim, att_num, att_dim
        self.noise = noise
        g = np.random.default_rng(seed)
        V = dataset.vocab_size + 1
        self.word_emb_fc = g.standard_normal((V, fc_dim)).astype(np.float32)
        self.word_emb_att = g.standard_normal((V, att_dim)).astype(np.float32)
        self.seed = seed

    def load(self, image_id, variant: str = "original"):
        caps = self.ds.captions_for_image(image_id)
        toks = caps[0][caps[0] > 0]
        from .dataset import stable_feature_seed

        g = np.random.default_rng(
            stable_feature_seed(image_id, variant, self.seed)
        )
        fc = self.word_emb_fc[toks].mean(0) + self.noise * g.standard_normal(self.fc_dim)
        # att position p holds the embedding of the p-th caption token
        att = np.zeros((self.att_num, self.att_dim), np.float32)
        for p in range(self.att_num):
            if p < len(toks):
                att[p] = self.word_emb_att[toks[p]]
        att += self.noise * g.standard_normal(att.shape)
        return fc.astype(np.float32), att.astype(np.float32)


def learnable_setup(
    caption_model: str = "show_tell",
    n_train: int = 48,
    batch_size: int = 8,
    seq_per_img: int = 5,
    rnn_size: int = 48,
    seed: int = 0,
    **opt_overrides,
):
    """(opt, loader) over the learnable fixture (single encoder)."""
    ds = synthetic_dataset(n_train=n_train, n_val=8, n_test=8, seed=seed,
                           correlated=True)
    fc_dim, att_num, att_dim = 24, 8, 16
    feats = [{"fc_feat_size": fc_dim, "att_feat_size": att_dim, "att_num": att_num}]
    opt = Options(
        caption_model=caption_model,
        feature_type="synthetic_single",
        feat_array_info=feats,
        batch_size=batch_size,
        seq_per_img=seq_per_img,
        top_words_count=len(ds.top_words),
        rnn_size=rnn_size,
        input_encoding_size=rnn_size,
        att_hid_size=rnn_size,
        num_review_steps=opt_overrides.pop("num_review_steps", 2),
        num_review_steps_0=opt_overrides.pop("num_review_steps_0", 2),
        seed=seed,
        **opt_overrides,
    )
    opt.vocab_size = ds.vocab_size
    opt.seq_length = ds.seq_length
    sources = [LearnableFeatureSource(ds, fc_dim, att_num, att_dim, seed=seed)]
    loader = DataLoader(opt, ds, sources, prefetch=False)
    return opt, loader


def synthetic_setup(
    caption_model: str = "recurrent_fusion_model",
    num_encoders: int = 3,
    fc_dims: Tuple[int, ...] = (16, 12, 14),
    att_dims: Tuple[int, ...] = (10, 8, 12),
    att_nums: Tuple[int, ...] = (6, 4, 5),
    batch_size: int = 4,
    seq_per_img: int = 5,
    prefetch: bool = False,
    seed: int = 0,
    **opt_overrides,
):
    """Build (opt, model-ready loader) for smoke runs and tests."""
    ds = synthetic_dataset(seed=seed)
    feats = [
        {"fc_feat_size": fc_dims[i], "att_feat_size": att_dims[i], "att_num": att_nums[i]}
        for i in range(num_encoders)
    ]
    if caption_model != "recurrent_fusion_model":
        feats = feats[:1]
    opt = Options(
        caption_model=caption_model,
        feature_type=("feat_array" if caption_model == "recurrent_fusion_model"
                      else "synthetic_single"),
        feat_array_info=feats,
        batch_size=batch_size,
        seq_per_img=seq_per_img,
        top_words_count=len(ds.top_words),
        rnn_size=opt_overrides.pop("rnn_size", 16),
        input_encoding_size=opt_overrides.pop("input_encoding_size", 16),
        att_hid_size=opt_overrides.pop("att_hid_size", 16),
        num_review_steps=opt_overrides.pop("num_review_steps", 2),
        num_review_steps_0=opt_overrides.pop("num_review_steps_0", 2),
        seed=seed,
        **opt_overrides,
    )
    opt.vocab_size = ds.vocab_size
    opt.seq_length = ds.seq_length
    sources = [
        SyntheticFeatureSource(f["fc_feat_size"], f["att_num"], f["att_feat_size"], seed=seed + i)
        for i, f in enumerate(feats)
    ]
    loader = DataLoader(opt, ds, sources, prefetch=prefetch)
    return opt, loader
