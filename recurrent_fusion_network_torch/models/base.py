"""Shared model protocol pieces and the model factory.

Counterpart of ``recurrent_fusion_network_tpu/models/base.py`` for the
pieces decoding and the XE train step need, ``remat_wrap`` (activation
rematerialisation, ``--use_remat``) among them.

Feature arguments: RFNet takes sequences of M per-encoder tensors; the
single-encoder models (ShowTell, ReviewNet) take a tensor or a sequence of
one (``single_encoder``), as the port's drivers hand every model lists.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import additive_attention as aa
from ..ops.cells import Draws, dropout_masks, uniform_draw
from ..ops.initializers import linear, tree_map, uniform

REMAT_POLICIES = ("save_ctx", "full")


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


def embed_tokens(params, tokens, vocab_parallel=None):
    """Token embeddings. With ``vocab_parallel`` (an mp rank's
    ``parallel/mesh.py::VocabParallel``) ``params["embed"]`` holds the
    rank's rows of the table, and the rows are gathered over the mp
    ranks."""
    if vocab_parallel is None:
        return params["embed"][tokens]
    return vocab_parallel.embed(params["embed"], tokens)


def vocab_logits(logits_fn, h, vocab_parallel=None):
    """``logits_fn(h)``, the logits over the vocabulary. With
    ``vocab_parallel`` the logit params hold the mp rank's columns, and
    the columns are gathered over the mp ranks."""
    if vocab_parallel is None:
        return logits_fn(h)
    return vocab_parallel.logits(logits_fn, h)


def vocab_parallel_field():
    """The models' ``vocab_parallel`` field: None, or the mp rank's share
    of the vocabulary under a dp x mp mesh (``training/train_loop.py``
    sets it on the model of the train step)."""
    return dataclasses.field(default=None, compare=False, repr=False)


def tile_for_lanes(tree, n_lanes: int):
    """Repeat every leaf along batch axis 0: (B, ...) -> (B*n_lanes, ...),
    image-major (each image's block of lanes is contiguous)."""
    return tree_map(lambda x: torch.repeat_interleave(x, n_lanes, dim=0), tree)


def remat_wrap(fn, policy: str = "save_ctx"):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are not kept for the backward but recomputed there.

    "full":     everything is recomputed; only ``fn``'s inputs and outputs
                (the carries) are kept, and each attention read launches
                its forward kernel a second time.
    "save_ctx": as "full", but every attention read's context and weights
                (z (B, D), w (B, A); the JAX package's ``attn_ctx`` /
                ``attn_weights``) are kept from the forward and handed back
                to the recompute (``kernels/additive_attention.py::
                recording`` / ``replaying``), which launches no forward
                kernel and reads no (B, A, D) features for it.
    The values are the forward's either way. ``fn`` must not draw random
    numbers (the recompute would draw others): its caller draws them ahead
    and passes them in (``ops/cells.py::Draws``). Any other policy raises
    ValueError.
    """
    if policy not in REMAT_POLICIES:
        # a typo ('save-ctx') must not silently degrade to another remat
        raise ValueError(
            f"unknown remat policy {policy!r} (expected 'save_ctx' or 'full')")

    def context_fn():
        if policy == "full":
            return contextlib.nullcontext(), contextlib.nullcontext()
        tape = []
        return aa.recording(tape), aa.replaying(tape)

    def wrapped(*args):
        if not torch.is_grad_enabled():  # no backward, nothing to recompute
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn,
                          preserve_rng_state=False)

    return wrapped


def review_step(step, model, *, n_cells, rate, generator, training, like):
    """A review loop's ``step(s, carry, rand)`` as the loop calls it, ``(s,
    carry)``: as it is, or under ``model.use_remat`` rematerialised with
    ``model.remat_policy``, its ``n_cells`` dropout masks of (B,
    model.rnn_size) drawn before it runs (B rows and the device of
    ``like``)."""
    if not model.use_remat:
        return lambda s, carry: step(s, carry, generator)
    wrapped = remat_wrap(lambda s, carry, masks: step(s, carry, Draws(masks)),
                         model.remat_policy)
    shapes = [(like.shape[0], model.rnn_size)] * n_cells
    return lambda s, carry: wrapped(
        s, carry, dropout_masks(generator, shapes, rate, training, device=like.device))


def xe_decode(decode_logprobs_fn, embed_fn, state, seq_in, *, ss_prob=0.0,
              generator=None, remat=False, remat_policy="save_ctx",
              step_draws=lambda generator: []):
    """Teacher-forced decode over time with scheduled sampling.

    decode_logprobs_fn: (xt, state, rand) -> (logprobs (B, V+1), state),
    ``rand`` the generator its dropout draws from (``Draws`` under remat);
    embed_fn: tokens -> embeddings; seq_in: (B, T) int input tokens (column
    0 is BOS = 0). Returns (B, T, V+1) log-probabilities.

    At step t >= 1 each row's input token is replaced, with probability
    ss_prob, by a draw from the previous step's predicted distribution (the
    coin a uniform draw, the draw by Gumbel-max, both from ``generator``:
    a ``torch.Generator`` or a data-parallel rank's ``RowShard`` of one).
    With ss_prob == 0 nothing is drawn, as the JAX ``lax.cond`` skips the
    draws; t = 0 always keeps the teacher token.

    With ``remat`` each step is ``remat_wrap``-ped under ``remat_policy``:
    its input token is chosen, and its dropout masks drawn
    (``step_draws(generator)``), before it runs, in the order the step
    without remat draws them.
    """
    B, T = seq_in.shape

    def step(tok, state, rand):
        return decode_logprobs_fn(embed_fn(tok), state, rand)

    if remat:
        wrapped = remat_wrap(lambda tok, state, masks: step(tok, state, Draws(masks)),
                             remat_policy)
    lps = []
    for t in range(T):
        tok = seq_in[:, t]
        if ss_prob > 0.0 and t >= 1:
            prev = lps[-1].detach()
            coin = uniform_draw((B,), generator, prev.device) < ss_prob
            u = uniform_draw(prev.shape, generator, prev.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
            sampled = torch.argmax(prev + gumbel, dim=-1)
            tok = torch.where(coin, sampled.to(tok.dtype), tok)
        if remat:
            lp, state = wrapped(tok, state, step_draws(generator))
        else:
            lp, state = step(tok, state, generator)
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
