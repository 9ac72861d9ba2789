"""Vocabulary construction and sequence decoding with the reference's
vocab semantics (counterpart of
``recurrent_fusion_network_tpu/data/vocab.py``): words counted more than a
threshold, else UNK; a 1-indexed vocabulary, token 0 = BOS/EOS/pad; a
sentence stops at the first 0."""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence

import numpy as np


def build_vocab(captions: Iterable[Sequence[str]], count_threshold: int = 5) -> List[str]:
    """Words counted more than ``count_threshold`` times, plus 'UNK' where a
    word was dropped (or none is left), by descending count then lexically;
    word i has token id i + 1."""
    counts = Counter()
    for cap in captions:
        counts.update(cap)
    vocab = [w for w, n in counts.items() if n > count_threshold]
    if any(n <= count_threshold for n in counts.values()) or not vocab:
        vocab.append("UNK")
    vocab.sort(key=lambda w: (-counts[w], w))
    return vocab


def encode_caption(cap: Sequence[str], word_to_ix: Dict[str, int], max_length: int) -> List[int]:
    """Token ids, clipped to max_length, UNK's for words out of the vocab."""
    unk = word_to_ix.get("UNK")
    return [word_to_ix.get(w, unk) for w in cap[:max_length]]


def ix_to_word_map(vocab: Sequence[str]) -> Dict[str, str]:
    """The info JSON's 'ix_to_word' table: string keys from 1."""
    return {str(i + 1): w for i, w in enumerate(vocab)}


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
