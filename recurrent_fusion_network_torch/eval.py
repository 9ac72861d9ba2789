"""Single-model evaluation CLI of the port.

Counterpart of the root ``eval.py`` (the reference's eval.py:28-99): load a
checkpoint triple (``--model_path`` directory, ``--load_model_id``,
``--rank``, ``--rl_prefix 1`` for the SCST ``rl_`` triple), adopt its saved
opt where the command line does not own the flag (``config.CLI_WINS``), then
``eval_split`` on ``--eval_split`` and print the loss and the metrics. Runs
on the CUDA device unless ``--device cpu``:

  python -m recurrent_fusion_network_torch.eval --model_path checkpoint \\
      --load_model_id rfnet --eval_split test --beam_size 3

With ``--image_folder DIR`` it captions the folder's raw images instead
(``training/eval_folder.py``: a resnet101 backbone at 448 px, a 14 x 14
grid, weights from ``--backbone_weights``, random without) and prints one
``file<TAB>caption`` line per image.
"""

from __future__ import annotations

import os

from .config import merge_checkpoint_opt, parse_opt
from .convert import check_params, params_from_jax
from .data.build import build_loader
from .device import resolve_device
from .models import setup
from .ops.initializers import tree_map
from .training.checkpoint import load_checkpoint
from .training.eval_folder import eval_image_folder
from .training.eval_split import eval_split


def main(argv=None):
    """Parse ``argv`` (default: the command line), evaluate, print; returns
    (loss, predictions, lang_stats), or with --image_folder the captions."""
    opt = parse_opt(argv)
    device = resolve_device(opt.device)  # no CUDA and no --device cpu: raise first
    ckpt_dir = opt.model_path or opt.checkpoint_path
    if os.path.isfile(ckpt_dir):
        d, f = os.path.split(ckpt_dir)
        raise SystemExit(
            f"--model_path must be the checkpoint DIRECTORY (got file {ckpt_dir!r}); "
            f"try --model_path {d or '.'} with --load_model_id <id> (file {f!r} follows "
            "model_{id}_{rank} naming)")
    params_np, infos = load_checkpoint(ckpt_dir, opt.load_model_id, opt.rank, best=True,
                                       prefix="rl_" if opt.rl_prefix else "")
    if "opt" in infos:
        merge_checkpoint_opt(opt, infos["opt"])
    if opt.image_folder:
        return eval_folder(opt, params_np, infos, device)
    loader = build_loader(opt, synthetic=bool(opt.synthetic_features))
    try:
        opt.vocab_size = loader.vocab_size
        opt.seq_length = loader.seq_length
        model = setup(opt)
        params = params_from_jax(params_np)
        check_params(model, params)
        params = tree_map(lambda t: t.to(device), params)
        loss, preds, stats = eval_split(model, params, loader, opt, split=opt.eval_split,
                                        beam_size=opt.beam_size, verbose=bool(opt.verbose))
    finally:
        loader.close()
    print(f"loss: {loss:.4f}")
    for k, v in (stats or {}).items():
        print(f"{k}: {v:.4f}")
    return loss, preds, stats


def eval_folder(opt, params_np, infos, device):
    """The --image_folder branch: caption raw images, print and return
    [{'image_id', 'file', 'caption'}]. As in the JAX package, the backbone
    is ``eval_image_folder``'s default (resnet101, 448 px, 14 x 14) whatever
    ``--backbone_arch`` says."""
    vocab = infos.get("vocab")
    if not vocab:
        raise ValueError("checkpoint infos hold no vocab (needed for --image_folder)")
    opt.vocab_size = len(vocab)
    opt.seq_length = infos.get("opt", {}).get("seq_length") or 16
    model = setup(opt)
    params = params_from_jax(params_np)
    check_params(model, params)
    params = tree_map(lambda t: t.to(device), params)
    preds = eval_image_folder(model, params, vocab, opt.image_folder,
                              beam_size=opt.beam_size, batch_size=opt.batch_size,
                              backbone_weights=opt.backbone_weights or None, device=device)
    for p in preds:
        print(f"{p['file']}\t{p['caption']}")
    return preds


if __name__ == "__main__":
    main()
