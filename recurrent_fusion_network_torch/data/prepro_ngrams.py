"""CIDEr-D document-frequency precompute CLI: the runbook's prepro stage.

The port's copy of ``recurrent_fusion_network_tpu/data/prepro_ngrams.py``
(the reference's scripts/prepro_ngrams.py): n-gram (n = 1..4) document
frequencies over the train split's captions, the idf table of the SCST
reward scorer. The SCST CLI builds it from the label matrix with
``compute_doc_freq`` when no ``--cider_df`` pickle exists; the CLI writes
that pickle, with ``--karpathy_json`` from the untruncated sentence tokens
as the reference does (``compute_doc_freq_karpathy``). n-gram keys are
tuples of int token ids:

  {"document_frequency": {(id, ...): df, ...}, "ref_len": log(#images)}

Usage:
  python -m recurrent_fusion_network_torch.data.prepro_ngrams \
      --input_json data/cocotalk.json --input_labels data/cocotalk_label.npz \
      --karpathy_json data/dataset_coco.json --output_pkl data/coco-train-idxs.p
"""

from __future__ import annotations

import argparse
import json
import pickle
from collections import defaultdict

import numpy as np

from ..rewards.cider_d import trim_with_eos
from .dataset import Dataset
from .prepro_labels import caption_tokens


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
    the reference's untruncated sent['tokens'] source (the CLI's
    --karpathy_json counts those, ``compute_doc_freq_karpathy``)."""
    df = defaultdict(float)
    for image_id in split_ids:
        caps = dataset.captions_for_image(image_id)
        grams = set()
        for cap in caps:
            grams |= seq_ngrams(cap)
        for g in grams:
            df[g] += 1.0
    return dict(df)


def compute_doc_freq_karpathy(images, word_to_ix, split: str = "train",
                              include_restval: bool = True, n_max: int = 4):
    """The reference's df source: each sentence's untruncated tokens plus
    EOS, words out of the vocabulary mapped to UNK, over the images of
    ``split`` (train with restval unless ``include_restval`` is off; "all"
    takes every image). -> (df, number of images); ref_len = log(images)."""
    unk = word_to_ix.get("UNK")
    df = defaultdict(float)
    n_img = 0
    for img in images:
        s = img.get("split", "train")
        if not (s == split or split == "all"
                or (split == "train" and include_restval and s == "restval")):
            continue
        n_img += 1
        grams = set()
        for sent in img["sentences"]:
            ids = [int(word_to_ix.get(w, unk)) for w in caption_tokens(sent)] + [0]
            for n in range(1, n_max + 1):
                for i in range(len(ids) - n + 1):
                    grams.add(tuple(ids[i: i + n]))
        for g in grams:
            df[g] += 1.0
    return dict(df), n_img


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_json", required=True)
    p.add_argument("--input_labels", required=True)
    p.add_argument("--output_pkl", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--include_restval", type=int, default=1)
    p.add_argument("--karpathy_json", default=None,
                   help="the Karpathy dataset JSON: count df over the untruncated "
                        "sentence tokens, as the reference does (the label matrix "
                        "is truncated at max_length)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    ds = Dataset.from_files(args.input_json, args.input_labels)
    if args.karpathy_json:
        with open(args.karpathy_json) as f:
            images = json.load(f)["images"]
        word_to_ix = {w: int(i) for i, w in ds.ix_to_word.items()}
        df, n = compute_doc_freq_karpathy(images, word_to_ix, split=args.split,
                                          include_restval=bool(args.include_restval))
    else:
        splits = ds.splits(train_only=not args.include_restval)
        ids = ([i for s in ("train", "val", "test") for i in splits[s]]
               if args.split == "all" else splits[args.split])
        df, n = compute_doc_freq(ds, ids), len(ids)
    out = {"document_frequency": df, "ref_len": float(np.log(n))}
    with open(args.output_pkl, "wb") as f:
        pickle.dump(out, f)
    print(f"images={n} ngrams={len(df)} ref_len={out['ref_len']:.4f}")


if __name__ == "__main__":
    main()
