"""Self-critical (SCST) training CLI of the port.

Counterpart of the root ``main_rl.py`` (the reference's main_rl.py +
train_rl.py): a warm start from the XE best triple with ``--start_from``
and ``--load_model_id`` (or ``--rl_resume 1`` from the run's own ``rl_``
triple), rewarded with train-idf CIDEr-D. ``--cider_df`` names the
document-frequency pickle of ``prepro_ngrams``; where it does not exist the
table is built from the train split's label matrix. Runs on the CUDA device
unless ``--device cpu``:

  python -m recurrent_fusion_network_torch.main_rl --caption_model recurrent_fusion_model \\
      --feature_type feat_array --start_from checkpoint --load_model_id rfnet --id rfnet \\
      --cider_df data/coco-train-idxs.p --batch_size 50

``--n_seeds N`` trains an SCST fleet (``training/multi_seed.py``), seed r
warm-started from rank r's XE best triple.
"""

from __future__ import annotations

import argparse

import numpy as np

from .config import parse_opt
from .data.build import build_loader
from .data.prepro_ngrams import compute_doc_freq
from .device import resolve_device
from .rewards.cider_d import CiderD
from .training.multi_seed import train_multi_seed_rl
from .training.train_rl_loop import train_rl


def make_scorer(path: str, loader, log_fn=print) -> CiderD:
    """The CIDEr-D reward scorer of ``path``, or of the train split's
    labels where there is no such file."""
    try:
        return CiderD.from_pickle(path)
    except FileNotFoundError:
        log_fn(f"cider df pickle not found at {path}; building from the train split "
               "labels (slower first run)")
    ids = loader.split_image_id["train"]
    return CiderD(compute_doc_freq(loader.dataset, ids), float(np.log(len(ids))))


def main(argv=None):
    """Parse ``argv`` (default: the command line), train; returns the
    infos (a fleet's result dict under ``--n_seeds`` > 1)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--cider_df", type=str, default="data/coco-train-idxs.p")
    pre_args, rest = pre.parse_known_args(argv)
    opt = parse_opt(rest)
    resolve_device(opt.device)  # no CUDA and no --device cpu: raise first
    loader = build_loader(opt, synthetic=bool(opt.synthetic_features))
    try:
        scorer = make_scorer(pre_args.cider_df, loader)
        max_it = opt.max_iterations if opt.max_iterations > 0 else None
        if opt.n_seeds > 1:
            return train_multi_seed_rl(opt, loader, scorer, opt.n_seeds,
                                       max_iterations=max_it)
        return train_rl(opt, loader, scorer, rank=0, max_iterations=max_it)
    finally:
        loader.close()


if __name__ == "__main__":
    main()
