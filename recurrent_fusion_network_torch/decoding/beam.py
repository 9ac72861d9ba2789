"""Batched beam search.

Counterpart of ``recurrent_fusion_network_tpu/decoding/beam.py`` with the
same reference semantics:

  * token 0 is both BOS and EOS/padding;
  * at t == 1 only beam 0 is live;
  * a beam whose previous token is 0 is dead and contributes no candidates;
  * a beam is done when it emits 0 or the length limit is reached, and done
    beams keep their accumulated log-prob;
  * the answer is the done beam with the highest accumulated log-prob; the
    top-K done beams are returned too.

All B images x K beams run as one image-major (B*K)-lane batch. Decoding
runs through step L-1 and ends with a select-only step at t == L. The
top-K selections break ties by lower index, as ``lax.top_k`` does (a stable
descending sort). ``t`` is a host integer, so no step reads a tensor value
on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.initializers import tree_leaves, tree_map

NEG = -1e30


class BeamOut(NamedTuple):
    seq: torch.Tensor  # (B, L) best done beam's tokens
    seq_logprobs: torch.Tensor  # (B, L) its per-token log-probs
    top_seq: torch.Tensor  # (B, K, L) top-K done beams
    top_p: torch.Tensor  # (B, K) their accumulated log-probs


def _top_k(x, k: int):
    """Largest k along dim 1, sorted descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _gather_lanes(tree, parent, B: int, K: int):
    """Reorder lane-major carry leaves (B*K, ...) by per-image parent (B, K)."""
    lanes = (torch.arange(B, device=parent.device)[:, None] * K + parent).reshape(-1)
    return tree_map(lambda x: x.index_select(0, lanes), tree)


def beam_search(step_fn, init_carry, batch_size: int, beam_size: int,
                seq_length: int, vocab_width: int, *, tile_carry: bool = True):
    """Run beam search for a batch.

    step_fn: (tokens (B*K,), carry) -> (logprobs (B*K, V+1), carry). Memory
      closed over by step_fn must already be tiled to B*K image-major lanes
      (models.base.tile_for_lanes).
    init_carry: decoder state tree; tiled here to B*K lanes when tile_carry.
    """
    B, K, L, V = batch_size, beam_size, seq_length, vocab_width
    if K > V:
        raise ValueError("beam_size must not exceed the vocab width")
    carry = (tree_map(lambda x: torch.repeat_interleave(x, K, dim=0), init_carry)
             if tile_carry else init_carry)
    device = tree_leaves(carry)[0].device

    # t = 0: feed BOS on every lane
    lp, carry = step_fn(torch.zeros((B * K,), dtype=torch.long, device=device), carry)
    prev_lp = lp.reshape(B, K, V)
    beam_seq = torch.zeros((B, K, L), dtype=torch.long, device=device)
    beam_lps = torch.zeros((B, K, L), device=device)
    beam_sum = torch.zeros((B, K), device=device)
    last_tok = torch.ones((B, K), dtype=torch.long, device=device)
    done_seq = torch.zeros((B, K, L), dtype=torch.long, device=device)
    done_lps = torch.zeros((B, K, L), device=device)
    done_p = torch.full((B, K), NEG, device=device)

    for t in range(1, L + 1):
        scores = beam_sum[:, :, None] + prev_lp  # (B, K, V)
        if t > 1:
            scores = scores.masked_fill((last_tok == 0)[:, :, None], NEG)  # dead
        else:
            scores[:, 1:, :] = NEG  # only beam 0 is live at t == 1
        vals, idx = _top_k(scores.reshape(B, K * V), K)  # (B, K) each
        parent = torch.div(idx, V, rounding_mode="floor")
        token = idx % V
        local_lp = prev_lp.reshape(B, K * V).gather(1, idx)

        # fork beams: gather histories by parent, then write position t-1
        sel = parent[:, :, None].expand(B, K, L)
        new_seq = beam_seq.gather(1, sel)
        new_lps = beam_lps.gather(1, sel)
        new_seq[:, :, t - 1] = token
        new_lps[:, :, t - 1] = local_lp

        # done-beam collection (EOS or length cutoff)
        cand_p = vals if t == L else torch.where(token == 0, vals, NEG)
        keep_p, keep_i = _top_k(torch.cat([done_p, cand_p], dim=1), K)
        keep = keep_i[:, :, None].expand(B, K, L)
        done_seq = torch.cat([done_seq, new_seq], dim=1).gather(1, keep)
        done_lps = torch.cat([done_lps, new_lps], dim=1).gather(1, keep)
        done_p = keep_p
        if t == L:
            break  # select-only final step: its decode would be discarded

        # rearrange recurrent state to the forked beams and decode one step
        carry = _gather_lanes(carry, parent, B, K)
        lp, carry = step_fn(token.reshape(B * K), carry)
        prev_lp = lp.reshape(B, K, V)
        beam_seq, beam_lps, beam_sum, last_tok = new_seq, new_lps, vals, token

    return BeamOut(seq=done_seq[:, 0, :], seq_logprobs=done_lps[:, 0, :],
                   top_seq=done_seq, top_p=done_p)
