"""Full-pipeline quality proxy on the port.

Counterpart of the root ``pipeline_proxy.py``: the reference's quality
chain (readme.md:3 — XE training, then the SCST fine-tune, then the
multi-checkpoint ensemble) run end to end on the learnable synthetic corpus
(``LearnableFeatureSource``: 3 encoders whose features encode the captions'
content, 2000 train images), with the same gates:

    CIDEr(RL ensemble) > max CIDEr(RL single)
    CIDEr(RL single) >= CIDEr(XE single) on every seed (or its paired-
                        bootstrap 95% CI of the per-image delta reaches 0)
    CIDEr(RL single) >  CIDEr(XE single) on a majority of seeds
    the SCST advantage (mean sampled - greedy CIDEr-D) rises
    SCST moved the params

asserted at full scale only, as the root script does, and the same result
keys, plus ``card`` (the card's name and power limit as nvidia-smi prints
them, or "cpu"). Runs on the CUDA device unless ``--device cpu``:

  python -m recurrent_fusion_network_torch.pipeline_proxy            # full run
  python -m recurrent_fusion_network_torch.pipeline_proxy --quick    # smoke run

The result goes to ``--out`` (PIPELINE_PROXY_TORCH.json), never to the root
script's PIPELINE_PROXY.json. The SCST fleet counts its warm start's
iterations from 0, as the JAX fleet does, so it is given the root script's
``max_iterations``: the SCST iterations themselves.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np

from .config import Options
from .convert import params_from_jax
from .data.loader import DataLoader
from .data.prepro_ngrams import compute_doc_freq
from .data.synthetic import LearnableFeatureSource, synthetic_dataset
from .device import resolve_device
from .ops.initializers import tree_leaves, tree_map
from .rewards.cider_d import CiderD
from .training.checkpoint import load_checkpoint
from .training.eval_ensemble import eval_ensemble
from .training.eval_split import eval_split
from .training.multi_seed import train_multi_seed, train_multi_seed_rl

WORD_BANK = [f"w{i:03d}" for i in range(120)]  # the root script's 120 words


def build_corpus(seed, n_train, n_val, n_test, work_dir, batch_size,
                 tied_att_keys=0, low_rank_ctx=0, device="cuda"):
    """(opt, loader) of the learnable 3-encoder corpus: each encoder an
    independent random view of the captions' content (root
    pipeline_proxy.py:70-131), on ``device``."""
    ds = synthetic_dataset(
        n_train=n_train, n_val=n_val, n_test=n_test, seq_length=10,
        vocab_words=WORD_BANK, top_words_count=60, seed=seed, correlated=True,
        diversity=0.35,
    )
    feats = [
        {"fc_feat_size": 96, "att_feat_size": 64, "att_num": 10},
        {"fc_feat_size": 64, "att_feat_size": 48, "att_num": 8},
        {"fc_feat_size": 80, "att_feat_size": 56, "att_num": 12},
    ]
    opt = Options(
        caption_model="recurrent_fusion_model",
        feature_type="feat_array",
        feat_array_info=feats,
        batch_size=batch_size,
        seq_per_img=5,
        top_words_count=len(ds.top_words),
        rnn_size=96,
        input_encoding_size=96,
        att_hid_size=96,
        num_review_steps=4,
        num_review_steps_0=4,
        drop_prob_lm=0.1,
        drop_prob_reason=0.1,
        drop_prob_fusion=0.1,
        optim_lr=4e-3,
        optim_rl_lr=5e-4,
        entropy_reg=0.01,
        language_eval=1,
        use_flip=1,
        use_crop=1,  # 10 variants: 10 noise draws an image
        seed=seed,
        tied_att_keys=tied_att_keys,
        low_rank_ctx=low_rank_ctx,
        id="proxy",
        checkpoint_path=work_dir,
        eval_results_dir=f"{work_dir}/eval_results",
        device=device,
    )
    opt.vocab_size = ds.vocab_size
    opt.seq_length = ds.seq_length
    sources = [
        LearnableFeatureSource(
            ds, f["fc_feat_size"], f["att_num"], f["att_feat_size"],
            seed=seed + 17 * (i + 1), noise=0.02,
        )
        for i, f in enumerate(feats)
    ]
    loader = DataLoader(opt, ds, sources, prefetch=False)
    return opt, loader


def test_cider(model, params, loader, opt, rank=0):
    """(test-split CIDEr, {image_id: per-image CIDEr}) of the greedy decode
    (the SCST baseline's policy) of ``params``, a tree on the host or on
    ``opt.device`` (root pipeline_proxy.py:134-167)."""
    from .metrics.coco_eval import evaluate_captions
    from .training.eval_split import default_gts_lookup

    device = resolve_device(opt.device)
    params = tree_map(lambda t: t.to(device), params)
    _, preds, _ = eval_split(
        model, params, loader, opt, split="test", rank=rank,
        language_eval_flag=False, beam_size=1,
    )
    lookup = default_gts_lookup(loader)
    gts, res = {}, {}
    for p in preds:
        refs = lookup(p["image_id"])
        if refs:
            gts[p["image_id"]] = list(refs)
            res[p["image_id"]] = [p["caption"]]
    scored = evaluate_captions(gts, res, spice=None)
    per_img = {k: float(v["CIDEr"]) for k, v in scored["img_scores"].items()}
    return float(scored["overall"]["CIDEr"]), per_img


def paired_bootstrap_delta(xe_img, rl_img, n_boot=10000, seed=0):
    """95% CI of mean(RL - XE) per-image CIDEr over the shared test images
    (root pipeline_proxy.py:170-188)."""
    ids = sorted(set(xe_img) & set(rl_img), key=str)
    d = np.array([rl_img[i] - xe_img[i] for i in ids])
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(d), (n_boot, len(d)))
    means = d[idx].mean(axis=1)
    return {
        "mean": float(d.mean()),
        "ci_lo": float(np.percentile(means, 2.5)),
        "ci_hi": float(np.percentile(means, 97.5)),
        "n_images": int(len(d)),
    }


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _fingerprint(tree):
    """The sum of |x| over every leaf: equal before and after means SCST
    moved nothing."""
    return float(sum(float(t.detach().abs().sum()) for t in tree_leaves(tree)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="reduced iterations")
    ap.add_argument("--work_dir",
                    default=os.path.join(tempfile.gettempdir(), "pipeline_proxy_torch"))
    ap.add_argument("--out", default="PIPELINE_PROXY_TORCH.json")
    ap.add_argument("--seeds", type=int, default=2,
                    help="fleet size (the full recipe uses 8 members)")
    ap.add_argument("--tied_att_keys", type=int, default=0,
                    help="run the tied-key variant")
    ap.add_argument("--low_rank_ctx", type=int, default=0,
                    help="run the low-rank-context variant")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the chain, write ``--out``; -> the result dict. Outside
    ``--quick`` a gate that fails raises AssertionError (after the JSON is
    written)."""
    args = parse_args(argv)
    device = resolve_device(args.device)  # no CUDA and no --device cpu: raise first
    n_seeds = args.seeds
    if args.quick:
        n_train, n_val, n_test = 60, 16, 16
        xe_iters, rl_iters, batch = 120, 40, 8
        eval_every = 60
    else:
        # no memorizable train split (a memorized policy saturates the
        # train-side reward, and SCST has nothing left to optimize)
        n_train, n_val, n_test = 2000, 150, 150
        xe_iters, rl_iters, batch = 2500, 1000, 16
        eval_every = 500

    t0 = time.time()
    corpus = dict(work_dir=args.work_dir, batch_size=batch,
                  tied_att_keys=args.tied_att_keys, low_rank_ctx=args.low_rank_ctx,
                  device=args.device)

    # ---------------------------------------------------------- XE fleet
    opt, loader = build_corpus(1, n_train, n_val, n_test, **corpus)
    opt.save_checkpoint_every = eval_every
    print(f"[proxy] XE fleet: {n_seeds} seeds x {xe_iters} iters "
          f"({n_train} train images, vocab {opt.vocab_size})")
    xe = train_multi_seed(opt, loader, n_seeds, max_iterations=xe_iters,
                          eval_at_end=True, log_fn=print)
    model = xe["model"]
    xe_scored = [
        test_cider(model, xe["best_params"][r], loader, opt, rank=r)
        for r in range(n_seeds)
    ]
    xe_test = [s for s, _ in xe_scored]
    xe_img = [d for _, d in xe_scored]
    print(f"[proxy] XE test CIDEr per seed: {xe_test}")

    # ---------------------------------------------------------- SCST fleet
    opt2, loader2 = build_corpus(1, n_train, n_val, n_test, **corpus)
    opt2.save_checkpoint_every = eval_every
    opt2.start_from = args.work_dir
    opt2.load_model_id = "proxy"
    train_ids = loader2.split_image_id["train"]
    scorer = CiderD(compute_doc_freq(loader2.dataset, train_ids),
                    float(np.log(len(train_ids))))
    print(f"[proxy] SCST fleet: {n_seeds} seeds x {rl_iters} iters")
    rl = train_multi_seed_rl(opt2, loader2, scorer, n_seeds,
                             max_iterations=rl_iters, eval_at_end=True,
                             log_fn=print)
    # non-vacuous SCST evidence: seed 0's final params differ from its warm
    # start (the XE best it loaded); the ordering gates alone pass with an
    # inert RL loop that ships the XE weights
    rl_params_changed = abs(
        _fingerprint(rl["params"][0]) - _fingerprint(xe["best_params"][0])
    ) > 1e-9

    rl_scored = [
        test_cider(model, rl["best_params"][r], loader2, opt2, rank=r)
        for r in range(n_seeds)
    ]
    rl_test = [s for s, _ in rl_scored]
    rl_img = [d for _, d in rl_scored]
    print(f"[proxy] RL test CIDEr per seed: {rl_test}")

    # per-seed paired bootstrap of the RL - XE per-image delta: the noise
    # floor of the per-seed gates
    delta_ci = [paired_bootstrap_delta(xe_img[r], rl_img[r], seed=r)
                for r in range(n_seeds)]
    print(f"[proxy] RL-XE paired delta CIs: {delta_ci}")

    # ---------------------------------------------------------- ensemble
    members = []
    for r in range(n_seeds):
        p, _ = load_checkpoint(args.work_dir, "proxy", r, best=True, prefix="rl_")
        members.append((model, params_from_jax(p)))
    _, ens_stats = eval_ensemble(
        members, loader2, opt2, split="test", beam_size=1,
        val_images_use=n_test,
    )
    ens_cider = float(ens_stats["CIDEr"])
    print(f"[proxy] RL {n_seeds}-model ensemble test CIDEr: {ens_cider}")

    # SCST optimizes mean(sampled - greedy) CIDEr-D: its trend is the direct
    # evidence that the policy-gradient loop works
    adv = []
    for r in range(n_seeds):
        h = sorted(rl["reward_histories"][r].items())
        vals = [v for _, v in h]
        k = max(1, len(vals) // 5)
        adv.append({"start": float(np.mean(vals[:k])),
                    "end": float(np.mean(vals[-k:]))})

    rl_gt_xe_per_seed = [bool(r_ > x_ + 1e-9)
                         for r_, x_ in zip(rl_test, xe_test)]
    # a seed holds the line numerically or within its paired CI
    rl_ge_xe_raw_per_seed = [bool(r_ >= x_ - 1e-6)
                             for r_, x_ in zip(rl_test, xe_test)]
    rl_ge_xe_per_seed = [
        raw or bool(ci["ci_hi"] >= 0.0)
        for raw, ci in zip(rl_ge_xe_raw_per_seed, delta_ci)
    ]
    rl_val_beat_warm_start = [
        bool(rl["cider_per_seed"][r] is not None
             and xe["cider_per_seed"][r] is not None
             and rl["cider_per_seed"][r] > xe["cider_per_seed"][r] + 1e-9)
        for r in range(n_seeds)
    ]

    result = {
        "corpus": {"n_train": n_train, "n_val": n_val, "n_test": n_test,
                   "vocab_size": opt.vocab_size, "seq_length": opt.seq_length},
        "xe_iters": xe_iters,
        "rl_iters": rl_iters,
        "xe_test_cider": xe_test,
        "rl_test_cider": rl_test,
        "ensemble_test_cider": ens_cider,
        "n_seeds": n_seeds,
        "scst_advantage": adv,
        "rl_params_changed": bool(rl_params_changed),
        "rl_gt_xe": bool(np.mean(rl_test) > np.mean(xe_test)),
        "rl_ge_xe": bool(np.mean(rl_test) >= np.mean(xe_test) - 1e-6),
        "rl_gt_xe_per_seed": rl_gt_xe_per_seed,
        "rl_ge_xe_raw_per_seed": rl_ge_xe_raw_per_seed,
        "rl_ge_xe_per_seed": rl_ge_xe_per_seed,
        "rl_xe_delta_ci_per_seed": delta_ci,
        "rl_val_beat_warm_start": rl_val_beat_warm_start,
        "rl_ge_xe_all_seeds": bool(all(rl_ge_xe_per_seed)),
        "rl_gt_xe_majority": bool(
            sum(rl_gt_xe_per_seed) * 2 > len(rl_gt_xe_per_seed)
        ),
        "xe_val_best_per_seed": [None if v is None else float(v)
                                 for v in xe["cider_per_seed"]],
        "rl_val_best_per_seed": [None if v is None else float(v)
                                 for v in rl["cider_per_seed"]],
        "scst_advantage_improved": bool(
            np.mean([a["end"] for a in adv]) > np.mean([a["start"] for a in adv])
        ),
        "ensemble_gt_single": bool(ens_cider > max(rl_test)),
        "wall_seconds": round(time.time() - t0, 1),
        "tied_att_keys": bool(args.tied_att_keys),
        "low_rank_ctx": bool(args.low_rank_ctx),
        "quick": bool(args.quick),
        "card": card_name(device),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))

    if n_seeds < 2:
        # a 1-member ensemble decodes as its member: the gate would compare
        # a number with itself
        print("[proxy] note: ensemble gate needs >= 2 seeds; skipping it")
        result["ensemble_gt_single"] = True
    ok = (result["rl_ge_xe_all_seeds"] and result["ensemble_gt_single"]
          and result["scst_advantage_improved"]
          and result["rl_params_changed"]
          and result["rl_gt_xe_majority"])
    if args.quick and not ok:
        # an undertrained smoke run: orderings are asserted at full scale only
        print("[proxy] WARN (quick mode): ordering not established at smoke "
              f"scale: {result}")
        return result
    assert result["ensemble_gt_single"], (
        f"ensemble {ens_cider} <= best single {max(rl_test)}"
    )
    assert result["rl_ge_xe_all_seeds"], (
        f"SCST degraded test CIDEr for a seed: XE {xe_test} vs RL {rl_test}"
    )
    assert result["rl_gt_xe_majority"], (
        "SCST produced no strict test-CIDEr improvement for a majority of "
        f"seeds: XE {xe_test} vs RL {rl_test} (per-seed gt: "
        f"{rl_gt_xe_per_seed}; val-beat-warm-start: {rl_val_beat_warm_start})"
    )
    assert result["scst_advantage_improved"], (
        f"SCST advantage did not improve: {adv}"
    )
    assert result["rl_params_changed"], (
        "SCST left the warm-start params untouched: the policy-gradient "
        "loop is inert (lr / optimizer / detach regression?)"
    )
    print("[proxy] PASS: ensemble > single, RL >= XE on every seed, strict "
          "RL > XE for a majority, SCST advantage rising")
    return result


if __name__ == "__main__":
    main()
