"""ROUGE-L: longest-common-subsequence F-measure (beta = 1.2).

The port's copy of ``recurrent_fusion_network_tpu/metrics/rouge.py``.

Clean-room implementation of the ROUGE-L variant used by coco-caption
(Lin 2004; max precision/recall over references then F-beta), replacing the
vendored pycocoevalcap/rouge/rouge.py.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

BETA = 1.2


def lcs_length(a: Sequence, b: Sequence) -> int:
    """Classic O(len(a)*len(b)) LCS."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_sentence(hyp: Sequence, refs: List[Sequence], beta: float = BETA) -> float:
    prec, rec = [], []
    for ref in refs:
        l = lcs_length(hyp, ref)
        prec.append(l / len(hyp) if hyp else 0.0)
        rec.append(l / len(ref) if ref else 0.0)
    p, r = max(prec), max(rec)
    if p != 0 and r != 0:
        return ((1 + beta**2) * p * r) / (r + beta**2 * p)
    return 0.0


def compute_rouge(gts: Dict, res: Dict):
    """Returns (mean score, per-sentence scores) over sorted keys."""
    scores = []
    for k in sorted(gts.keys(), key=str):
        hyp = res[k][0].split()
        refs = [r.split() for r in gts[k]]
        scores.append(rouge_l_sentence(hyp, refs))
    import numpy as np

    return float(np.mean(scores)), scores
