"""Shared model protocol pieces and the model factory.

Counterpart of ``recurrent_fusion_network_tpu/models/base.py`` for the
pieces decoding and the XE train step need. ``remat_wrap`` is not ported
(ROADMAP queue 1, M3 remainder): the attention models' forward raises for
``use_remat``.

Feature arguments: RFNet takes sequences of M per-encoder tensors; the
single-encoder models (ShowTell, ReviewNet) take a tensor or a sequence of
one (``single_encoder``), as the port's drivers hand every model lists.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple

import torch

from ..ops.initializers import linear, tree_map, uniform


class EncodeOut(NamedTuple):
    """Result of a model's image-conditioning phase.

    memory:       what the decoder attends over (thought vectors and their
                  precomputed attention keys for RFNet).
    state:        initial decoder recurrent state; every leaf has batch on
                  axis 0.
    reason_preds: (B, top_words) discriminative head outputs, M+1 for RFNet.
    """

    memory: Any
    state: Any
    reason_preds: List[torch.Tensor]


def init_embed_logit(generator, vocab_size: int, input_encoding_size: int,
                     rnn_size: int, *, device):
    """Token embedding (V+1, E) U(-0.1, 0.1) and output projection
    (R -> V+1) with uniform weight and zero bias."""
    embed = uniform(generator, (vocab_size + 1, input_encoding_size), device=device)
    logit = linear(generator, rnn_size, vocab_size + 1, bias=0.0, device=device)
    return embed, logit


def resolve_tied(opt) -> bool:
    """opt.tied_att_keys with the -1 'auto' sentinel: auto means tied unless
    --reference_parity."""
    tied = getattr(opt, "tied_att_keys", 0)
    if tied == -1:
        return not bool(getattr(opt, "reference_parity", 0))
    return bool(tied)


def single_encoder(feats):
    """A single-encoder model's features: a tensor, or a sequence holding
    one tensor (None passes through)."""
    if isinstance(feats, (list, tuple)):
        if len(feats) != 1:
            raise ValueError(f"expected one encoder's features, got {len(feats)}")
        return feats[0]
    return feats


def embed_tokens(params, tokens):
    return params["embed"][tokens]


def tile_for_lanes(tree, n_lanes: int):
    """Repeat every leaf along batch axis 0: (B, ...) -> (B*n_lanes, ...),
    image-major (each image's block of lanes is contiguous)."""
    return tree_map(lambda x: torch.repeat_interleave(x, n_lanes, dim=0), tree)


def xe_decode(decode_logprobs_fn, embed_fn, state, seq_in, *, ss_prob=0.0,
              generator=None):
    """Teacher-forced decode over time with scheduled sampling.

    decode_logprobs_fn: (xt, state) -> (logprobs (B, V+1), state);
    embed_fn: tokens -> embeddings; seq_in: (B, T) int input tokens (column
    0 is BOS = 0). Returns (B, T, V+1) log-probabilities.

    At step t >= 1 each row's input token is replaced, with probability
    ss_prob, by a draw from the previous step's predicted distribution (the
    coin from ``torch.rand``, the draw by Gumbel-max, both from
    ``generator``). With ss_prob == 0 nothing is drawn, as the JAX
    ``lax.cond`` skips the draws; t = 0 always keeps the teacher token.
    """
    B, T = seq_in.shape
    lps = []
    for t in range(T):
        tok = seq_in[:, t]
        if ss_prob > 0.0 and t >= 1:
            prev = lps[-1].detach()
            coin = torch.rand((B,), generator=generator, device=prev.device) < ss_prob
            u = torch.rand(prev.shape, generator=generator, device=prev.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
            sampled = torch.argmax(prev + gumbel, dim=-1)
            tok = torch.where(coin, sampled.to(tok.dtype), tok)
        lp, state = decode_logprobs_fn(embed_fn(tok), state)
        lps.append(lp)
    return torch.stack(lps, dim=1)


def setup(opt):
    """Model factory."""
    from .recurrent_fusion import RecurrentFusionModel
    from .review_net import ReviewNetModel
    from .show_tell import ShowTellModel

    if opt.caption_model == "show_tell":
        return ShowTellModel.from_opt(opt)
    if opt.caption_model == "review_net":
        return ReviewNetModel.from_opt(opt)
    if opt.caption_model == "recurrent_fusion_model":
        return RecurrentFusionModel.from_opt(opt)
    raise ValueError(f"Caption model not supported: {opt.caption_model}")
