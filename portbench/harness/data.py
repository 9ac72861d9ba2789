"""The benchmark's data, made from the seed: a synthetic caption corpus
with the configuration's vocabulary, and a pool of image features made on
the device once at set-up and kept in host memory, from which the port's
loader and the serving client copy rows as they would from a store.

The corpus: image ids 1..N, ``captions_per_image`` captions each, lengths
uniform in ``caption_length``, tokens 1 + floor(V u^3) (u uniform), so the
low ids, the configuration's top words, are frequent. Top word k is word
k + 1 (the ``top_words_count`` most frequent ids).
"""

from __future__ import annotations

import numpy as np
import torch

from .env import sub_seed


class Corpus:
    def __init__(self, seed: int, n_images: int, vocab_size: int, seq_length: int,
                 captions_per_image: int = 5, caption_length=(6, 16),
                 top_words_count: int = 1000):
        rng = np.random.default_rng(sub_seed(seed, "corpus"))
        self.n_images, self.caps = n_images, captions_per_image
        self.vocab_size, self.seq_length = vocab_size, seq_length
        self.top_words_count = top_words_count
        lo, hi = caption_length
        hi = min(hi, seq_length)
        lengths = rng.integers(lo, hi + 1, size=(n_images, captions_per_image))
        u = rng.random((n_images, captions_per_image, seq_length))
        toks = 1 + np.minimum(np.floor(vocab_size * u ** 3), vocab_size - 1).astype(np.int64)
        toks[np.arange(seq_length)[None, None, :] >= lengths[..., None]] = 0
        self.labels = toks  # (N, caps, L), 0 after each caption
        self.image_ids = np.arange(1, n_images + 1)

    def words(self):
        return {str(i): f"w{i}" for i in range(1, self.vocab_size + 1)}

    def top_words(self):
        return [f"w{i}" for i in range(1, self.top_words_count + 1)]

    def captions(self, image_id: int) -> np.ndarray:
        return self.labels[int(image_id) - 1]


class FeaturePool:
    """Features of ``n_images`` distinct images per encoder, standard
    normal, drawn on ``device`` from the seed (one draw per array) and
    copied once to host memory. Row i holds image id i + 1."""

    def __init__(self, encoders, n_images: int, seed: int, device):
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, "pool"))
        self.fc, self.att = [], []
        for e in encoders:
            fc = torch.randn((n_images, e["fc_feat_size"]), generator=g, device=device)
            att = torch.randn((n_images, e["att_num"], e["att_feat_size"]), generator=g,
                              device=device)
            self.fc.append(fc.cpu().numpy())
            self.att.append(att.cpu().numpy())
            del fc, att
        self.n_images = n_images

    def row(self, image_id) -> int:
        return (int(image_id) - 1) % self.n_images

    def features(self, image_id):
        """One image's (fc list, att list) as host arrays (views)."""
        r = self.row(image_id)
        return [f[r] for f in self.fc], [a[r] for a in self.att]

    def rows(self, image_ids, device, dtype=torch.float32):
        """(fc list, att list) of several images, copied to ``device``."""
        idx = np.array([self.row(i) for i in image_ids])
        return ([torch.from_numpy(f[idx]).to(device, dtype) for f in self.fc],
                [torch.from_numpy(a[idx]).to(device, dtype) for a in self.att])

    def nbytes(self) -> int:
        return sum(x.nbytes for x in self.fc + self.att)


class PoolSource:
    """Encoder ``j`` of the pool as a feature source of the port's loader
    (``load(image_id, variant) -> (fc, att)``, host arrays)."""

    def __init__(self, pool: FeaturePool, j: int):
        self.pool, self.j = pool, j

    def load(self, image_id, variant: str = "original"):
        r = self.pool.row(image_id)
        return self.pool.fc[self.j][r], self.pool.att[self.j][r]
