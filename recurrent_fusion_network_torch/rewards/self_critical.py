"""Self-critical (SCST) reward assembly.

Counterpart of ``recurrent_fusion_network_tpu/rewards/self_critical.py``
(the reference's get_rewards.py): ``compute_reward`` scores the sampled and
the greedy rollout with CIDEr-D (optionally + BLEU-4), subtracts the greedy
baseline, weights, and broadcasts each sentence's reward over its time
steps; ``get_self_critical_reward`` runs the greedy rollout first. SPICE
rewards are not ported (ROADMAP.md queue 1, SPICE back ends): a positive
``spice_weight`` raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..metrics.bleu import BleuScorer
from .cider_d import CiderD, trim_with_eos


def check_spice_weight(spice_weight: float) -> None:
    if spice_weight > 0:
        raise NotImplementedError(
            "SPICE rewards (spice_weight > 0) are not ported yet: the port has no "
            "metrics/spice* (ROADMAP.md queue 1, SPICE back ends)")


def compute_reward(cider_scorer: CiderD, gen_result: np.ndarray, greedy_res: np.ndarray,
                   gts: Sequence[np.ndarray], *, use_baseline: bool = True,
                   cider_weight: float = 1.0, bleu4_weight: float = 0.0,
                   spice_weight: float = 0.0) -> np.ndarray:
    """Per-time-step rewards (B, T), float64, of the sampled rollout.

    gen_result / greedy_res: (B, T) int arrays, 0 after EOS. gts: one full
    caption set per image; B must be a multiple of len(gts) (each image's
    seq_per_img rows are consecutive).
    """
    check_spice_weight(spice_weight)
    gen_result = np.asarray(gen_result)
    greedy_res = np.asarray(greedy_res)
    B, T = gen_result.shape
    n_img = len(gts)
    if n_img == 0 or B % n_img:
        raise ValueError(f"{B} rollout rows do not divide into {n_img} images' references")
    seq_per_img = B // n_img

    hyps = [gen_result[i] for i in range(B)] + [greedy_res[i] for i in range(B)]
    img_of = [(i % B) // seq_per_img for i in range(2 * B)]
    refs = [gts[j] for j in img_of]
    scores = cider_scorer.score_arrays(hyps, refs, ref_cache_keys=img_of)

    if bleu4_weight > 0:
        scorer = BleuScorer(4)
        # each image's references tokenised once for its 2 * seq_per_img rows
        ref_toks = [[[str(t) for t in trim_with_eos(r)] for r in g] for g in gts]
        for h, j in zip(hyps, img_of):
            scorer.append([str(t) for t in trim_with_eos(h)], ref_toks[j])
        _, per_sent = scorer.compute()
        bleu4 = np.array([s[3] for s in per_sent])
    else:
        bleu4 = np.zeros_like(scores)

    if use_baseline:
        scores, bleu4 = scores[:B] - scores[B:], bleu4[:B] - bleu4[B:]
    else:
        scores, bleu4 = scores[:B], bleu4[:B]
    combined = cider_weight * scores + bleu4_weight * bleu4
    return np.repeat(combined[:, None], T, axis=1)


def get_self_critical_reward(model, params, fc_feats, att_feats, gts, gen_result,
                             cider_scorer: CiderD, *, greedy_sample_fn=None,
                             **reward_kwargs) -> np.ndarray:
    """Run the greedy baseline rollout and compute the rewards
    (get_rewards.py:115-140). ``greedy_sample_fn(params, fc, att)`` overrides
    the rollout; by default it is ``decoding.api.model_sample`` at beam 1,
    arg-max, which on CUDA tensors runs ``additive_attention_fwd``."""
    if greedy_sample_fn is None:
        import torch

        from ..decoding.api import model_sample

        def greedy_sample_fn(params, fc, att):
            with torch.inference_mode():
                return model_sample(model, params, fc, att, beam_size=1, sample_max=True).seq

    greedy = greedy_sample_fn(params, fc_feats, att_feats)
    greedy_res = greedy.cpu().numpy() if hasattr(greedy, "cpu") else np.asarray(greedy)
    gen = gen_result.cpu().numpy() if hasattr(gen_result, "cpu") else np.asarray(gen_result)
    return compute_reward(cider_scorer, gen, greedy_res, gts, **reward_kwargs)
