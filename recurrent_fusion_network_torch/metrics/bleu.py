"""BLEU-1..4 with the 'closest' reference-length brevity penalty.

The port's copy of ``recurrent_fusion_network_tpu/metrics/bleu.py``: the
corpus scores of coco-caption's BLEU (``compute_bleu``, the metric column)
beside the smoothed per-sentence scores (the reference's BleuD) that the
SCST reward reads when ``bleu4_weight > 0``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

SMALL = 1e-9
TINY = 1e-15  # so that a guess count of 0 still scores 0


def _ngram_counts(tokens: Sequence, n_max: int) -> List[Counter]:
    return [Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))
            for n in range(1, n_max + 1)]


def _closest_ref_len(hyp_len: int, ref_lens: Sequence[int]) -> int:
    return min(ref_lens, key=lambda r: (abs(r - hyp_len), r))


class BleuScorer:
    """Accumulate (hypothesis, references) pairs; ``compute`` gives corpus
    and per-sentence BLEU-1..4."""

    def __init__(self, n: int = 4):
        self.n = n
        self.hyps: List[List] = []
        self.refs: List[List[List]] = []

    def append(self, hyp_tokens: Sequence, refs_tokens: Sequence[Sequence]):
        self.hyps.append(list(hyp_tokens))
        self.refs.append([list(r) for r in refs_tokens])

    def compute(self) -> Tuple[List[float], List[List[float]]]:
        n = self.n
        total_correct, total_guess = [0] * n, [0] * n
        total_hyp_len = total_ref_len = 0
        per_sentence: List[List[float]] = []
        for hyp, refs in zip(self.hyps, self.refs):
            hyp_counts = _ngram_counts(hyp, n)
            ref_counts = [_ngram_counts(r, n) for r in refs]
            hyp_len = len(hyp)
            ref_len = _closest_ref_len(hyp_len, [len(r) for r in refs]) if refs else 0
            total_hyp_len += hyp_len
            total_ref_len += ref_len
            correct, guess = [0] * n, [0] * n
            for k in range(n):
                max_ref = Counter()
                for rc in ref_counts:
                    for g, c in rc[k].items():
                        if c > max_ref[g]:
                            max_ref[g] = c
                for g, c in hyp_counts[k].items():
                    correct[k] += min(c, max_ref.get(g, 0))
                guess[k] = max(0, hyp_len - k)
                total_correct[k] += correct[k]
                total_guess[k] += guess[k]
            # smoothed per-sentence score with its own brevity penalty
            if hyp_len >= ref_len:
                bp = 1.0
            else:
                bp = math.exp(1 - ref_len / max(hyp_len, 1)) if hyp_len > 0 else 0.0
            sent, logs = [], 0.0
            for k in range(n):
                logs += math.log(correct[k] + TINY) - math.log(guess[k] + SMALL)
                sent.append(math.exp(logs / (k + 1)) * bp)
            per_sentence.append(sent)

        bp = (1.0 if total_hyp_len >= total_ref_len
              else math.exp(1 - total_ref_len / max(total_hyp_len, 1)))
        corpus, logs = [], 0.0
        for k in range(n):
            logs += math.log(total_correct[k] + TINY) - math.log(total_guess[k] + SMALL)
            corpus.append(math.exp(logs / (k + 1)) * bp)
        return corpus, per_sentence


def compute_bleu(gts: Dict, res: Dict, n: int = 4):
    """gts / res: {key: [tokenized sentence strings]}, one sentence per key
    in res. -> (corpus scores [n], per-sentence scores as n lists in
    string-sorted key order): pycocoevalcap's Bleu.compute_score."""
    scorer = BleuScorer(n)
    for k in sorted(gts.keys(), key=str):
        scorer.append(res[k][0].split(), [r.split() for r in gts[k]])
    corpus, per_sent = scorer.compute()
    return corpus, [[s[i] for s in per_sent] for i in range(n)]
