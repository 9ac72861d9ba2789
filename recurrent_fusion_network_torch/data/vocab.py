"""Sequence decoding with the reference's vocab semantics: 1-indexed
vocabulary, token 0 = BOS/EOS/pad, a sentence stops at the first 0
(counterpart of ``recurrent_fusion_network_tpu/data/vocab.py``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def decode_sequence(ix_to_word: Dict[str, str], seq) -> List[str]:
    """Token-id matrix (N, D) -> list of sentences; stops at the first 0."""
    out = []
    for row in np.asarray(seq):
        words = []
        for ix in row:
            if int(ix) <= 0:
                break
            words.append(ix_to_word[str(int(ix))])
        out.append(" ".join(words))
    return out
