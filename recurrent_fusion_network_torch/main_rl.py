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
warm-started from rank r's XE best triple. ``--num_dp_devices D`` /
``--async_opt 1`` and a launcher's environment start data-parallel ranks as
in ``main.py``: each rank rolls out and scores its block of every batch.
``--num_mp_devices`` above 1 is refused before the loader is built, as the
JAX CLI refuses it (the dp x mp mesh is a solo XE capability).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .config import dp_devices, parse_opt
from .data.build import build_loader
from .data.prepro_ngrams import compute_doc_freq
from .device import resolve_device
from .main import join_group, spawn_ranks
from .parallel import distributed
from .parallel.mesh import MP_RL
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


def parse_args(argv=None):
    """-> (the CLI's own flags, the options of ``parse_opt``)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--cider_df", type=str, default="data/coco-train-idxs.p")
    pre_args, rest = pre.parse_known_args(argv)
    return pre_args, parse_opt(rest)


def main(argv=None):
    """Parse ``argv`` (default: the command line), train; returns the
    infos (a fleet's result dict under ``--n_seeds`` > 1), or None where it
    started the data-parallel ranks."""
    argv = sys.argv[1:] if argv is None else list(argv)
    pre_args, opt = parse_args(argv)
    if opt.num_mp_devices > 1:  # before the loader and the df fallback (JAX :26-29)
        raise ValueError(MP_RL)
    resolve_device(opt.device)  # no CUDA and no --device cpu: raise first
    world = dp_devices(opt)
    if world > 1 and not distributed.launched():
        spawn_ranks(opt, world, main, argv)
        return None
    mesh = join_group(opt, world) if distributed.launched() else None
    try:
        loader = build_loader(opt, synthetic=bool(opt.synthetic_features))
        try:
            scorer = make_scorer(pre_args.cider_df, loader)
            max_it = opt.max_iterations if opt.max_iterations > 0 else None
            if opt.n_seeds > 1:
                return train_multi_seed_rl(opt, loader, scorer, opt.n_seeds,
                                           max_iterations=max_it, mesh=mesh)
            return train_rl(opt, loader, scorer, rank=0, max_iterations=max_it, mesh=mesh)
        finally:
            loader.close()
    finally:
        if mesh is not None:
            distributed.shutdown()


if __name__ == "__main__":
    main()
