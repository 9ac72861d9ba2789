"""Model-level decode API: greedy / categorical sampling when
``beam_size == 1``, beam search otherwise (counterpart of
``recurrent_fusion_network_tpu/decoding/api.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.base import tile_for_lanes
from .beam import beam_search
from .engine import make_step_fn
from .sample import sample


class ModelSampleOut(NamedTuple):
    seq: torch.Tensor  # (B, L)
    seq_logprobs: torch.Tensor  # (B, L)
    logprobs_all: Optional[torch.Tensor]  # (B, L+1, V+1), sampling path only
    top_seq: Optional[torch.Tensor]  # (B, K, L), beam path only
    top_p: Optional[torch.Tensor]  # (B, K), beam path only
    reason_preds: list


def model_sample(model, params, fc_feats, att_feats, *, beam_size: int = 1,
                 sample_max: bool = True, temperature: float = 1.0,
                 generator=None):
    """Encode then decode a batch with the requested strategy."""
    enc = model.encode(params, fc_feats, att_feats)
    B = fc_feats[0].shape[0]
    V1 = model.vocab_size + 1
    if beam_size > 1:
        step = make_step_fn(model, params, tile_for_lanes(enc.memory, beam_size))
        out = beam_search(step, enc.state, B, beam_size, model.seq_length, V1)
        return ModelSampleOut(out.seq, out.seq_logprobs, None, out.top_seq,
                              out.top_p, enc.reason_preds)
    step = make_step_fn(model, params, enc.memory)
    out = sample(step, enc.state, B, model.seq_length, V1, sample_max=sample_max,
                 temperature=temperature, generator=generator)
    return ModelSampleOut(out.seq, out.seq_logprobs, out.logprobs_all, None, None,
                          enc.reason_preds)
