"""CIDEr / CIDEr-D: tf-idf n-gram cosine consensus metric.

The port's copy of ``recurrent_fusion_network_tpu/metrics/cider.py``.

Clean-room implementation of Vedantam et al. 2015 (CIDEr) and its CIDEr-D
variant (count clipping + Gaussian length penalty), replacing the vendored
cider/pyciderevalcap/ciderD scorer. Works over any hashable token type
(strings for metric evaluation, int ids for the RL reward hot path).

Semantics matched to the reference scorer (ciderD_scorer.py:114-199):
  * weight(g) = tf(g) * (ref_len - log(max(1, df(g))))        [:126-134]
  * 'length' used in the penalty counts BIGRAMS (the reference's n==1 index
    quirk at :136-137) — identical delta for hyp/ref, preserved verbatim
  * sim_n = sum_g min(h_g, r_g) * r_g / (|h_n| |r_n|)          [:157-162]
    (CIDEr-D clipping; plain CIDEr uses h_g * r_g)
  * CIDEr-D multiplies by exp(-delta^2 / (2 sigma^2))           [:166]
  * score = 10 * mean_n(sim_n) averaged over references         [:191-196]
  * corpus df mode: df computed over THIS call's reference sets; ref_len =
    log(#images)                                                [:170-171,201-207]
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np


def ngram_counter(tokens: Sequence[Hashable], n_max: int = 4) -> Counter:
    """All 1..n_max-grams as a single Counter keyed by tuple."""
    c: Counter = Counter()
    L = len(tokens)
    for n in range(1, n_max + 1):
        for i in range(L - n + 1):
            c[tuple(tokens[i : i + n])] += 1
    return c


class CiderScorer:
    """Batch scorer. Build with either corpus-mode df (computed from the refs
    passed to compute) or a fixed df table + ref_len (train-idf RL mode)."""

    def __init__(
        self,
        n: int = 4,
        sigma: float = 6.0,
        *,
        df: Dict[tuple, float] | None = None,
        ref_len: float | None = None,
        cider_d: bool = True,
    ):
        self.n = n
        self.sigma = sigma
        self.df = df
        self.ref_len = ref_len
        self.cider_d = cider_d
        if df is not None:
            assert ref_len is not None, "fixed-df mode needs ref_len"

    # ------------------------------------------------------------ internals

    def _vec(self, counts: Counter, df, ref_len):
        """tf-idf vectors per n: ({n: {gram: w}}, norms[n], bigram_length)."""
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for gram, tf in counts.items():
            d = math.log(max(1.0, df.get(gram, 0.0)))
            k = len(gram) - 1
            w = tf * (ref_len - d)
            vec[k][gram] = w
            norm[k] += w * w
            if k == 1:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vh, vr, nh, nr, lh, lr):
        delta = float(lh - lr)
        val = np.zeros(self.n)
        for k in range(self.n):
            acc = 0.0
            for gram, hw in vh[k].items():
                rw = vr[k].get(gram, 0.0)
                if self.cider_d:
                    acc += min(hw, rw) * rw
                else:
                    acc += hw * rw
            if nh[k] != 0 and nr[k] != 0:
                acc /= nh[k] * nr[k]
            val[k] = acc
        if self.cider_d:
            val *= math.exp(-(delta**2) / (2 * self.sigma**2))
        return val

    # --------------------------------------------------------------- public

    def compute(
        self,
        hyps: List[Sequence[Hashable]],
        refs: List[List[Sequence[Hashable]]],
    ) -> Tuple[float, np.ndarray]:
        """hyps[i] is one token sequence; refs[i] its reference set."""
        assert len(hyps) == len(refs)
        hyp_counts = [ngram_counter(h, self.n) for h in hyps]
        # share counters across entries that pass the SAME refs list object
        # (e.g. several hyps of one image) so the downstream id()-keyed
        # vector cache actually hits — rebuilding per entry made it dead
        rc_cache: Dict[int, list] = {}
        ref_counts = []
        for rs in refs:
            k = id(rs)
            if k not in rc_cache:
                rc_cache[k] = [ngram_counter(r, self.n) for r in rs]
            ref_counts.append(rc_cache[k])

        if self.df is None:
            # corpus mode: df over the distinct reference sets of this call
            df: Dict[tuple, float] = defaultdict(float)
            for rs in ref_counts:
                # count each unique ngram once per entry's reference set
                # (duplicated entries count again — reference behavior,
                # ciderD_scorer.py:108-111)
                grams = set()
                for rc in rs:
                    grams |= set(rc.keys())
                for g in grams:
                    df[g] += 1.0
            ref_len = math.log(float(len(ref_counts)))
        else:
            df, ref_len = self.df, self.ref_len

        # cache ref vectors by identity of the counter list (repeated images)
        scores = np.zeros(len(hyps))
        ref_vec_cache: Dict[int, list] = {}
        for i, (hc, rcs) in enumerate(zip(hyp_counts, ref_counts)):
            vh, nh, lh = self._vec(hc, df, ref_len)
            total = np.zeros(self.n)
            for rc in rcs:
                ck = id(rc)
                if ck not in ref_vec_cache:
                    ref_vec_cache[ck] = self._vec(rc, df, ref_len)
                vr, nr, lr = ref_vec_cache[ck]
                total += self._sim(vh, vr, nh, nr, lh, lr)
            s = float(np.mean(total)) / len(rcs) * 10.0
            scores[i] = s
        return float(np.mean(scores)), scores


def compute_cider(gts: Dict, res: Dict, *, cider_d: bool = True):
    """pycocoevalcap-style surface over tokenized-string dicts."""
    keys = sorted(gts.keys(), key=str)
    hyps = [res[k][0].split() for k in keys]
    refs = [[r.split() for r in gts[k]] for k in keys]
    scorer = CiderScorer(cider_d=cider_d)
    return scorer.compute(hyps, refs)
