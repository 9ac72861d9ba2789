"""CIDEr-D over int token-id sequences: the SCST reward.

The port's copy of ``recurrent_fusion_network_tpu/rewards/cider_d.py``:

  * n-grams of int ids are hashed into int64 keys (base 2^15 per token, the
    n-gram order tagged in the top bits), so no strings are built;
  * each sentence's tf-idf vector is a sorted (key, weight) array per
    order, and the clipped cosine takes ``np.intersect1d``;
  * each distinct reference set is vectorised once per call
    (``ref_cache_keys``).

Two engines compute the same scores: NumPy, and the C++ library of
``csrc/cider_d.cpp`` (``rewards/native.py``). They sum in different orders,
so they agree to float64 rounding, not bit for bit. EOS inclusion, idf
weighting, clipping, the Gaussian length penalty and the x10 scale are the
reference scorer's.
"""

from __future__ import annotations

import ctypes
import math
import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils.profiling import span

N_MAX = 4
KEY_BASE = np.int64(1) << 15  # token ids must be < 32768
_N_TAG = np.int64(1) << 60  # tells the n-gram orders apart in the key space


def hash_ngrams(toks: np.ndarray, n_max: int = N_MAX):
    """(keys per order, counts per order, bigram length) of all 1..n_max-grams
    of one sentence. The key of (t1..tk) is tag(k) + ((t1*B + t2)*B + ...),
    unique per n-gram since ids < B and the order is tagged."""
    toks = np.asarray(toks, np.int64)
    L = len(toks)
    keys_per_n, counts_per_n = [], []
    length = 0
    for n in range(1, n_max + 1):
        m = L - n + 1
        if m <= 0:
            keys_per_n.append(np.empty(0, np.int64))
            counts_per_n.append(np.empty(0, np.int64))
            continue
        k = toks[:m].copy()
        for j in range(1, n):
            k = k * KEY_BASE + toks[j: j + m]
        k += _N_TAG * n
        u, c = np.unique(k, return_counts=True)
        keys_per_n.append(u)
        counts_per_n.append(c)
        if n == 2:
            length = m  # the reference's 'length' is the bigram count
    return keys_per_n, counts_per_n, length


def hash_ngram_tuple(gram: Tuple[int, ...]) -> int:
    k = np.int64(0)
    for t in gram:
        k = k * KEY_BASE + np.int64(t)
    return int(k + _N_TAG * len(gram))


def trim_with_eos(ids) -> np.ndarray:
    """Tokens up to and including the first 0 (the reference's
    ``array_to_str``)."""
    ids = np.asarray(ids).ravel()
    nz = np.nonzero(ids == 0)[0]
    end = int(nz[0]) + 1 if len(nz) else len(ids)
    return ids[:end].astype(np.int64)


class _SentVec:
    __slots__ = ("keys", "weights", "norms", "length")

    def __init__(self, keys, weights, norms, length):
        self.keys = keys  # n sorted int64 arrays
        self.weights = weights  # n float64 arrays
        self.norms = norms  # (n,) float64
        self.length = length


class CiderD:
    """Fixed-idf CIDEr-D scorer (the reference's train-idf RL mode).

    df: {int n-gram tuple: document frequency} or a pre-hashed {int64:
    float} dict. ref_len: log(number of training images).
    backend: "auto" (the native engine, NumPy where no C++ compiler is
    found), "native" (raises where it cannot be built) or "numpy".
    ``engine`` says which one scores.
    """

    def __init__(self, df: Dict, ref_len: float, n: int = N_MAX, sigma: float = 6.0,
                 backend: str = "auto", n_threads: int = 0):
        if not 1 <= n <= N_MAX:
            # the int64 key packs n 15-bit token digits under a 2^60 order
            # tag: four fit, n = 5 would wrap around and alias
            raise ValueError(f"n must be in [1, {N_MAX}] (int64 key capacity)")
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown CIDEr-D backend {backend!r}")
        self.n = n
        self.sigma = sigma
        self.ref_len = float(ref_len)
        if df and isinstance(next(iter(df.keys())), tuple):
            self.df = {hash_ngram_tuple(g): float(v) for g, v in df.items()}
        else:
            self.df = dict(df)
        if self.df:
            ks = np.fromiter(self.df.keys(), np.int64, len(self.df))
            vs = np.fromiter(self.df.values(), np.float64, len(self.df))
            order = np.argsort(ks)
            self._df_keys = ks[order]
            self._df_vals = np.log(np.maximum(1.0, vs[order]))
        else:
            self._df_keys = np.empty(0, np.int64)
            self._df_vals = np.empty(0, np.float64)

        self._native = None
        self._native_ctx = None
        self.engine = "numpy"
        if backend != "numpy":
            from .native import load_library

            lib = load_library(required=backend == "native")
            if lib is not None:
                keys = np.ascontiguousarray(self._df_keys)
                vals = np.ascontiguousarray(self._df_vals)
                self._native_ctx = lib.cider_init(
                    keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    len(keys), self.ref_len, self.n, self.sigma)
                self._native = lib
                self._n_threads = n_threads or min(8, os.cpu_count() or 1)
                self.engine = "native"

    def __del__(self):
        if getattr(self, "_native_ctx", None):
            self._native.cider_free(self._native_ctx)
            self._native_ctx = None

    @classmethod
    def from_pickle(cls, path: str, **kw):
        """A scorer from a document-frequency pickle (``prepro_ngrams``'s
        ``{"document_frequency": ..., "ref_len": ...}``), written by this
        project: unpickling runs code, so load no other file."""
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(d["document_frequency"], d["ref_len"], **kw)

    # ------------------------------------------------------------ internals

    def _log_df(self, keys: np.ndarray) -> np.ndarray:
        """log(max(1, df)) per key; unseen n-grams get log(1) = 0."""
        idx = np.searchsorted(self._df_keys, keys)
        idx = np.clip(idx, 0, max(len(self._df_keys) - 1, 0))
        out = np.zeros(len(keys))
        if len(self._df_keys):
            hit = self._df_keys[idx] == keys
            out[hit] = self._df_vals[idx[hit]]
        return out

    def _vec(self, ids) -> _SentVec:
        keys_per_n, counts_per_n, length = hash_ngrams(trim_with_eos(ids), self.n)
        weights, norms = [], np.zeros(self.n)
        for n in range(self.n):
            w = counts_per_n[n] * (self.ref_len - self._log_df(keys_per_n[n]))
            weights.append(w)
            norms[n] = math.sqrt(float(np.dot(w, w)))
        return _SentVec(keys_per_n, weights, norms, length)

    def _sim(self, h: _SentVec, r: _SentVec) -> float:
        val = 0.0
        for n in range(self.n):
            if h.norms[n] == 0 or r.norms[n] == 0:
                continue
            _, hi, ri = np.intersect1d(h.keys[n], r.keys[n], assume_unique=True,
                                       return_indices=True)
            if len(hi) == 0:
                continue
            hw, rw = h.weights[n][hi], r.weights[n][ri]
            val += float(np.sum(np.minimum(hw, rw) * rw)) / (h.norms[n] * r.norms[n])
        delta = float(h.length - r.length)
        return val * math.exp(-(delta ** 2) / (2 * self.sigma ** 2))

    # --------------------------------------------------------------- public

    def score_arrays(self, hyps: Sequence[np.ndarray],
                     refs_per_hyp: Sequence[Sequence[np.ndarray]],
                     ref_cache_keys: Sequence | None = None) -> np.ndarray:
        """Score each hypothesis against its reference set.

        ref_cache_keys: optional hashable per hypothesis naming its reference
        set; a set shared by several hypotheses is vectorised once. With the
        native engine the checks and the flattening are the span
        ``reward.prep``, the C++ scoring the span ``reward.native``.
        """
        with span("reward.prep"):
            self._check(hyps, refs_per_hyp)
            if self._native_ctx is not None:
                args, out = self._native_inputs(hyps, refs_per_hyp, ref_cache_keys)
        if self._native_ctx is not None:
            with span("reward.native"):
                self._native.cider_score(self._native_ctx, *args, self._n_threads)
            return out
        cache: Dict = {}
        scores = np.zeros(len(hyps))
        for i, hyp in enumerate(hyps):
            hv = self._vec(hyp)
            ck = ref_cache_keys[i] if ref_cache_keys is not None else i
            if ck not in cache:
                cache[ck] = [self._vec(r) for r in refs_per_hyp[i]]
            rvs = cache[ck]
            scores[i] = sum(self._sim(hv, rv) for rv in rvs) / self.n / len(rvs) * 10.0
        return scores

    @staticmethod
    def _check(hyps, refs_per_hyp) -> None:
        # ids >= KEY_BASE or < 0 would alias n-gram keys. The check runs on
        # every reward call, so it takes one min / max per distinct array
        # (seq_per_img expansion repeats the same reference array object)
        hi, lo = 0, 0
        seen: set = set()
        for a in list(hyps) + [r for rs in refs_per_hyp for r in rs]:
            if id(a) in seen or not np.size(a):
                continue
            seen.add(id(a))
            a = np.asarray(a)
            hi = max(hi, int(a.max()))
            lo = min(lo, int(a.min()))
        if hi >= KEY_BASE:
            raise ValueError(f"token id {hi} >= KEY_BASE ({int(KEY_BASE)}); n-gram "
                             "hashing would alias")
        if lo < 0:
            raise ValueError(f"negative token id {lo}: n-gram hashing requires ids in "
                             "[0, KEY_BASE); pad with 0 (EOS), not -1")
        # an empty reference set divides by zero: NumPy raises, the native
        # engine would return NaN and poison the batch's policy gradient
        for i, rs in enumerate(refs_per_hyp):
            if len(rs) == 0:
                raise ValueError(f"empty reference set for hypothesis {i}")

    @staticmethod
    def _native_inputs(hyps, refs_per_hyp, ref_cache_keys):
        """(the native ``cider_score``'s arguments between its context and
        its thread count, the scores array it fills)."""
        n_hyp = len(hyps)
        group_of: Dict = {}
        groups: List = []
        hyp_group = np.empty(n_hyp, np.int64)
        for i in range(n_hyp):
            ck = ref_cache_keys[i] if ref_cache_keys is not None else i
            if ck not in group_of:
                group_of[ck] = len(groups)
                groups.append(refs_per_hyp[i])
            hyp_group[i] = group_of[ck]

        def flatten(sents):
            # rows of one length (every rollout row is (T,)) in one copy
            n = len(sents)
            first_len = len(np.ravel(sents[0])) if n else 0
            if n and all(getattr(s, "ndim", None) == 1 and len(s) == first_len
                         for s in sents):
                flat = np.asarray(sents, np.int32).ravel()
                return flat, np.arange(n + 1, dtype=np.int64) * first_len
            off = np.zeros(n + 1, np.int64)
            for i, s in enumerate(sents):
                off[i + 1] = off[i] + len(np.ravel(s))
            flat = np.empty(off[-1], np.int32)
            for i, s in enumerate(sents):
                flat[off[i]: off[i + 1]] = np.ravel(s)
            return flat, off

        hyp_flat, hyp_off = flatten(list(hyps))
        all_refs = [r for g in groups for r in g]
        ref_flat, ref_off = flatten(all_refs)
        group_off = np.zeros(len(groups) + 1, np.int64)
        for g, refs in enumerate(groups):
            group_off[g + 1] = group_off[g] + len(refs)

        out = np.zeros(n_hyp, np.float64)
        i64 = ctypes.POINTER(ctypes.c_int64)
        i32 = ctypes.POINTER(ctypes.c_int32)
        # each pointer keeps its array alive until the call
        return (hyp_flat.ctypes.data_as(i32), hyp_off.ctypes.data_as(i64), n_hyp,
                ref_flat.ctypes.data_as(i32), ref_off.ctypes.data_as(i64), len(all_refs),
                group_off.ctypes.data_as(i64), len(groups), hyp_group.ctypes.data_as(i64),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))), out
