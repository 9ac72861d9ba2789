"""Multi-checkpoint ensemble decoding.

Counterpart of ``recurrent_fusion_network_tpu/decoding/ensemble.py`` (the
reference's ensemble eval paths, eval_utils.py:268-383 and :387-1493):
every member encodes once, then each decode step averages the members'
logits and log-softmaxes the mean (``engine.make_ensemble_step_fn``).
Members may share features (multi-seed ensembles, the reference's
eval_ensemble.py:30-37) or each read another encoder's features (the
ReviewNet 'diff_feat' ensembles, eval_utils.py:1026-1493).

All members run on one device, one after another inside each step; the
beam variant runs the whole batch as B*K lanes. The flip ensemble
(eval_ensemble.py:162-187) decodes the original and the flipped features
and keeps, per image, the sentence with the higher log-prob.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.base import tile_for_lanes
from .beam import beam_search
from .engine import make_ensemble_step_fn
from .sample import sample


class EnsembleOut(NamedTuple):
    seq: torch.Tensor  # (B, L)
    seq_logprobs: torch.Tensor  # (B, L)
    top_seq: Optional[torch.Tensor]  # (B, K, L), beam path only
    top_p: Optional[torch.Tensor]  # (B, K), beam path only


def ensemble_sample(models: Sequence, params_list: Sequence, feats_list: Sequence[Tuple], *,
                    beam_size: int = 1, sample_max: bool = True, temperature: float = 1.0,
                    generator=None) -> EnsembleOut:
    """Decode one batch with the mean-logit ensemble of the members
    ``zip(models, params_list)``; ``feats_list`` holds each member's
    (fc, att), per-encoder sequences or bare tensors. Beam search when
    ``beam_size > 1``; else greedy or (``sample_max=False``) categorical
    draws from ``generator``."""
    if not len(models) == len(params_list) == len(feats_list):
        raise ValueError("one params tree and one (fc, att) pair per member")
    encs = [model.encode(params, fc, att)
            for model, params, (fc, att) in zip(models, params_list, feats_list)]
    fc0 = feats_list[0][0]
    fc0 = fc0[0] if isinstance(fc0, (list, tuple)) else fc0
    B, V1, L = fc0.shape[0], models[0].vocab_size + 1, models[0].seq_length

    if beam_size > 1:
        step = make_ensemble_step_fn([
            (model, params, tile_for_lanes(enc.memory, beam_size))
            for model, params, enc in zip(models, params_list, encs)])
        states = tuple(tile_for_lanes(enc.state, beam_size) for enc in encs)
        out = beam_search(step, states, B, beam_size, L, V1, tile_carry=False)
        return EnsembleOut(out.seq, out.seq_logprobs, out.top_seq, out.top_p)

    step = make_ensemble_step_fn([(model, params, enc.memory)
                                  for model, params, enc in zip(models, params_list, encs)])
    out = sample(step, tuple(enc.state for enc in encs), B, L, V1, sample_max=sample_max,
                 temperature=temperature, generator=generator)
    return EnsembleOut(out.seq, out.seq_logprobs, None, None)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sentence_logprob(seq, seq_logprobs) -> np.ndarray:
    """sum(seq_logprobs * (seq > 0)) per row, the reference's sentence
    log-prob (eval_utils.py:690,947, feeding eval_ensemble.py:175-182): the
    mask aligns WITH the sequence, so the EOS step and everything after it
    are left out (not the SCST criterion's shifted mask)."""
    return (_host(seq_logprobs) * (_host(seq) > 0)).sum(axis=1)


def flip_combine(out_a: EnsembleOut, out_b: EnsembleOut) -> Tuple[np.ndarray, np.ndarray]:
    """Per image the sentence with the higher ``sentence_logprob`` of two
    decodes (eval_ensemble.py:162-187), beam or not -> (seq, its log-prob)
    on the host. As the reference's ``if prob_1 > prob_2``, the second
    (flipped) decode wins exact ties."""
    p_a = sentence_logprob(out_a.seq, out_a.seq_logprobs)
    p_b = sentence_logprob(out_b.seq, out_b.seq_logprobs)
    pick_a = p_a > p_b
    seq = np.where(pick_a[:, None], _host(out_a.seq), _host(out_b.seq))
    return seq, np.where(pick_a, p_a, p_b)
