"""Ensemble evaluation CLI of the port.

Counterpart of the root ``eval_ensemble.py`` (the reference's
eval_ensemble.py:25-193): load N checkpoint triples, decode with the
per-step mean of their logits (beam or greedy), optionally the flip
ensemble (``--eval_flip_ensemble 1``), and print the language metrics.
``--model_ids`` is a comma-separated list of ids, each ``id`` or
``id:rank``; ``--n_ranks N`` expands one id to ranks 0..N-1 (a fleet's
per-seed triples share one id); ``--rl_prefix 1`` loads the ``rl_`` (SCST)
triples; ``--diff_feat 1`` gives member i the i-th encoder's features (the
ReviewNet diff-feat ensembles, eval_utils.py:1026-1493). The triples may be
the port's or the JAX package's. The first member's saved opt is adopted
where the command line does not own the flag (``config.CLI_WINS``); each
member keeps its own architecture keys (its (un)tied keys among them).
Runs on the CUDA device unless ``--device cpu``:

  python -m recurrent_fusion_network_torch.eval_ensemble --model_path checkpoint \\
      --model_ids rfnet --n_ranks 4 --rl_prefix 1 --beam_size 3 --dtype bfloat16
"""

from __future__ import annotations

import argparse

from .config import Options, merge_checkpoint_opt, parse_opt
from .convert import check_params, params_from_jax
from .data.build import build_loader
from .device import resolve_device
from .models import setup
from .training.checkpoint import ARCH_KEYS, load_checkpoint
from .training.eval_ensemble import eval_ensemble

# the saved opt keys each member keeps: those that fix its parameter tree
MEMBER_KEYS = ARCH_KEYS + ("num_expert",)


def member_pairs(model_ids: str, n_ranks: int):
    """``--model_ids`` and ``--n_ranks`` -> [(id, rank), ...]."""
    pairs = []
    for m in model_ids.split(","):
        mid, _, rank = m.partition(":")
        pairs.append((mid, int(rank) if rank else 0))
    if n_ranks > 1:
        if len(pairs) != 1 or pairs[0][1] != 0:
            raise SystemExit("--n_ranks expands a SINGLE model id over ranks; do not "
                             "combine it with id lists or id:rank")
        pairs = [(pairs[0][0], r) for r in range(n_ranks)]
    return pairs


def parse_args(argv=None):
    """-> (the CLI's own flags, the options of ``parse_opt``)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model_ids", type=str, required=True,
                     help="comma-separated checkpoint ids; 'id:rank' selects a rank "
                          "(default 0)")
    pre.add_argument("--n_ranks", type=int, default=1,
                     help="with one model id, load its ranks 0..n_ranks-1")
    pre.add_argument("--diff_feat", type=int, default=0)
    pre_args, rest = pre.parse_known_args(argv)
    return pre_args, parse_opt(rest)


def main(argv=None):
    """Parse ``argv`` (default: the command line), evaluate, print; returns
    (predictions, lang_stats)."""
    pre_args, opt = parse_args(argv)
    resolve_device(opt.device)  # no CUDA and no --device cpu: raise first
    ckpt_dir = opt.model_path or opt.checkpoint_path
    prefix = "rl_" if opt.rl_prefix else ""
    saved = []
    for mid, rank in member_pairs(pre_args.model_ids, pre_args.n_ranks):
        params_np, infos = load_checkpoint(ckpt_dir, mid, rank, best=True, prefix=prefix)
        if not saved and "opt" in infos:
            merge_checkpoint_opt(opt, infos["opt"])
        saved.append((infos.get("opt", {}), params_np))

    loader = build_loader(opt, synthetic=bool(opt.synthetic_features))
    try:
        opt.vocab_size = loader.vocab_size
        opt.seq_length = loader.seq_length
        members = []
        for i, (saved_opt, params_np) in enumerate(saved):
            mo = Options(**{**vars(opt), **{k: v for k, v in saved_opt.items()
                                            if k in MEMBER_KEYS}})
            if pre_args.diff_feat:  # member i is built on encoder i's widths
                mo.feat_array_info = opt.feat_array_info[i:i + 1]
            model = setup(mo)
            params = params_from_jax(params_np)
            check_params(model, params)
            members.append((model, params))
        preds, stats = eval_ensemble(members, loader, opt, split=opt.eval_split,
                                     beam_size=opt.beam_size,
                                     diff_feat=bool(pre_args.diff_feat),
                                     flip_ensemble=bool(opt.eval_flip_ensemble),
                                     verbose=bool(opt.verbose))
    finally:
        loader.close()
    print(f"predictions: {len(preds)}")
    for k, v in (stats or {}).items():
        print(f"{k}: {v:.4f}")
    return preds, stats


if __name__ == "__main__":
    main()
