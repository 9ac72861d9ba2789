"""CIDEr-D document frequencies over the train split's label matrix.

The port's copy of ``seq_ngrams`` and ``compute_doc_freq`` of
``recurrent_fusion_network_tpu/data/prepro_ngrams.py``: the SCST CLI builds
its reward scorer's idf table with them when no ``--cider_df`` pickle
exists. n-gram keys are tuples of int token ids:

  {(id, ...): df, ...}, with ref_len = log(#train images)
"""

from __future__ import annotations

from collections import defaultdict

from ..rewards.cider_d import trim_with_eos


def seq_ngrams(ids, n_max: int = 4):
    """All 1..n_max-grams of a 0-terminated id sequence, EOS included —
    a full-length row without a 0 terminator still gets its EOS n-grams
    appended (the reference counts sent['tokens'] + ['<eos>'] always,
    scripts/prepro_ngrams.py:96)."""
    toks = [int(t) for t in trim_with_eos(ids)]
    if not toks or toks[-1] != 0:
        toks.append(0)
    out = set()
    for n in range(1, n_max + 1):
        for i in range(len(toks) - n + 1):
            out.add(tuple(toks[i : i + n]))
    return out


def compute_doc_freq(dataset, split_ids):
    """df[ngram] = number of train images whose caption SET contains it
    (scripts/prepro_ngrams.py:66-77 semantics).

    Source caveat: counts from the label MATRIX, whose captions are
    truncated at max_length — n-grams past the cut are lost relative to
    the reference's untruncated sent['tokens'] source (the JAX package's
    prepro_ngrams CLI with --karpathy_json writes a reference-exact df
    pickle that --cider_df reads)."""
    df = defaultdict(float)
    for image_id in split_ids:
        caps = dataset.captions_for_image(image_id)
        grams = set()
        for cap in caps:
            grams |= seq_ngrams(cap)
        for g in grams:
            df[g] += 1.0
    return dict(df)
