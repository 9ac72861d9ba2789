"""Label preprocessing CLI: the runbook's prepro stage.

The port's copy of ``recurrent_fusion_network_tpu/data/prepro_labels.py``
(the reference's scripts/prepro_labels.py): a Karpathy-split JSON ->
vocabulary (words counted more than --word_count_threshold times, else
UNK), the label matrix of 1-indexed tokens clipped at --max_length, 1-based
label_start_ix / label_end_ix pointers, the cocotalk-style info JSON with
each image's raw sentences, and the top-words pickle (the most frequent
words of the train and restval captions) that --top_words_path reads.

Labels are written as .npz (keys 'labels', 'label_start_ix',
'label_end_ix'); an --output_labels ending in .h5 writes the reference's
h5 layout through h5py, imported only then.

Usage:
  python -m recurrent_fusion_network_torch.data.prepro_labels \\
      --input_json data/dataset_coco.json --output_json data/cocotalk.json \\
      --output_labels data/cocotalk_label.npz \\
      --output_top_words data/vocab_train.pkl [--word_count_threshold 5]
"""

from __future__ import annotations

import argparse
import json
import pickle
from collections import Counter

import numpy as np

from .vocab import build_vocab, encode_caption, ix_to_word_map


def caption_tokens(sent) -> list:
    """A Karpathy sentence's lower-cased tokens (the JSON ships them
    tokenized)."""
    return [w.lower() for w in sent["tokens"] if w.strip()]


def preprocess(karpathy: dict, max_length: int = 16, word_count_threshold: int = 5,
               top_words_count: int = 1000):
    """-> (info JSON dict, labels (N, max_length) int64, label_start_ix,
    label_end_ix, top words). Raises ValueError for a caption that encodes
    to no token (the reference's assert)."""
    images = karpathy["images"]
    toks = [[caption_tokens(s) for s in img["sentences"]] for img in images]
    vocab = build_vocab((t for per_img in toks for t in per_img), word_count_threshold)
    word_to_ix = {w: i + 1 for i, w in enumerate(vocab)}

    labels, starts, ends, out_images = [], [], [], []
    for img, img_toks in zip(images, toks):
        image_id = img.get("cocoid", img.get("imgid"))
        out_images.append({
            "id": image_id,
            "split": img.get("split", "train"),
            "file_path": (img.get("filepath", "") + "/" + img["filename"]).lstrip("/"),
            # the untruncated, un-UNKed references language_eval scores against
            "raw_sentences": [s.get("raw") or " ".join(s["tokens"]) for s in img["sentences"]],
        })
        if not img_toks:
            raise ValueError(f"image {image_id!r} has no captions")
        starts.append(len(labels) + 1)
        for t in img_toks:
            enc = encode_caption(t, word_to_ix, max_length)
            if not enc:
                raise ValueError(f"empty caption for image {image_id!r}: fix or drop the "
                                 "annotation")
            row = np.zeros(max_length, np.int64)
            row[:len(enc)] = enc
            labels.append(row)
        ends.append(len(labels))

    train_counts = Counter()
    for img, img_toks in zip(images, toks):
        if img.get("split", "train") in ("train", "restval"):
            for t in img_toks:
                train_counts.update(t)
    top_words = [w for w, _ in train_counts.most_common(top_words_count)]
    info = {"ix_to_word": ix_to_word_map(vocab), "images": out_images}
    return info, np.stack(labels), np.array(starts), np.array(ends), top_words


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_json", required=True)
    p.add_argument("--output_json", required=True)
    p.add_argument("--output_labels", required=True)
    p.add_argument("--output_top_words", default=None)
    p.add_argument("--max_length", type=int, default=16)
    p.add_argument("--word_count_threshold", type=int, default=5)
    p.add_argument("--top_words_count", type=int, default=1000)
    args = p.parse_args(argv)

    with open(args.input_json) as f:
        karpathy = json.load(f)
    info, labels, starts, ends, top_words = preprocess(
        karpathy, args.max_length, args.word_count_threshold, args.top_words_count)
    with open(args.output_json, "w") as f:
        json.dump(info, f)
    if args.output_labels.endswith(".h5"):
        import h5py

        with h5py.File(args.output_labels, "w") as h5:
            h5.create_dataset("labels", data=labels, dtype="uint32")
            h5.create_dataset("label_start_ix", data=starts, dtype="uint32")
            h5.create_dataset("label_end_ix", data=ends, dtype="uint32")
    else:
        np.savez(args.output_labels, labels=labels, label_start_ix=starts, label_end_ix=ends)
    if args.output_top_words:
        with open(args.output_top_words, "wb") as f:
            pickle.dump({"words": top_words}, f)
    print(f"vocab={len(info['ix_to_word'])} images={len(info['images'])} "
          f"captions={labels.shape[0]} top_words={len(top_words)}")


if __name__ == "__main__":
    main()
