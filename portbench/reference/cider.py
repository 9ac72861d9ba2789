"""CIDEr-D (Vedantam et al., CVPR 2015; the "-D" form of the coco-caption
code), written out over token ids: the SCST reward.

A sentence is its ids up to and including the first 0 (EOS). For n = 1..4
its n-gram counts are weighted by idf = ref_len - log(max(1, df)), where
df counts the training images whose caption set holds the n-gram (each
caption with its EOS appended) and ref_len = log(number of training
images). For each n the similarity of a hypothesis to one reference is
sum over shared n-grams of min(w_h, w_r) * w_r / (|w_h| |w_r|), the sum
over n times exp(-(l_h - l_r)^2 / (2 sigma^2)), sigma = 6, l the number of
bigrams. A hypothesis scores 10 x that, averaged over its references and
divided by 4.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np

N = 4
SIGMA = 6.0


def sentence(ids):
    ids = [int(t) for t in np.asarray(ids).ravel()]
    return ids[:ids.index(0) + 1] if 0 in ids else ids


def ngrams(toks, n):
    return Counter(tuple(toks[i:i + n]) for i in range(len(toks) - n + 1))


class Cider:
    def __init__(self, captions_per_image):
        """captions_per_image: for each training image, its captions (rows
        of ids, 0 after the caption)."""
        df = Counter()
        for caps in captions_per_image:
            grams = set()
            for c in caps:
                toks = sentence(c)
                if not toks or toks[-1] != 0:
                    toks = toks + [0]
                for n in range(1, N + 1):
                    grams |= set(ngrams(toks, n))
            df.update(grams)
        self.df = df
        self.ref_len = math.log(len(captions_per_image))

    def vec(self, ids):
        toks = sentence(ids)
        out, norms = [], []
        for n in range(1, N + 1):
            w = {g: c * (self.ref_len - math.log(max(1.0, self.df.get(g, 0.0))))
                 for g, c in ngrams(toks, n).items()}
            out.append(w)
            norms.append(math.sqrt(sum(x * x for x in w.values())))
        return out, norms, max(0, len(toks) - 1)

    def sim(self, h, r):
        (hw, hn, hl), (rw, rn, rl) = h, r
        val = 0.0
        for n in range(N):
            if hn[n] == 0 or rn[n] == 0:
                continue
            val += sum(min(v, rw[n][g]) * rw[n][g] for g, v in hw[n].items()
                       if g in rw[n]) / (hn[n] * rn[n])
        return val * math.exp(-((hl - rl) ** 2) / (2 * SIGMA ** 2))

    def scores(self, hyps, refs_per_hyp):
        """-> (len(hyps),) float64: each hypothesis against its references."""
        cache = {}
        out = np.zeros(len(hyps))
        for i, (h, refs) in enumerate(zip(hyps, refs_per_hyp)):
            key = id(refs)
            if key not in cache:
                cache[key] = [self.vec(r) for r in refs]
            hv = self.vec(h)
            out[i] = sum(self.sim(hv, rv) for rv in cache[key]) / len(cache[key]) / N * 10.0
        return out
