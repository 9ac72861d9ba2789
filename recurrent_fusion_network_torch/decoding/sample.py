"""Batched greedy / temperature sampling.

Counterpart of ``recurrent_fusion_network_tpu/decoding/sample.py``; the
JAX scan over time becomes a Python loop of seq_length+1 steps with the
same semantics:

  * t = 0 feeds BOS (token 0); sampling starts from the step-1 distribution.
  * greedy takes argmax; otherwise a categorical draw from
    logprobs / temperature, recording the un-tempered log-prob.
  * ``unfinished`` latches to 0 once a row emits token 0; recorded tokens are
    masked to 0 afterwards, but the embedding input uses the raw token.
  * once every row has finished, the remaining steps record zeros.

The loop never reads a tensor value on the host: ``alive`` stays a device
tensor, so the decode can be queued ahead of the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.initializers import tree_leaves


class SampleOut(NamedTuple):
    seq: torch.Tensor  # (B, L) int64, 0 after EOS
    seq_logprobs: torch.Tensor  # (B, L) log-prob of each sampled token
    logprobs_all: torch.Tensor  # (B, L+1, V+1) per-step log-distributions


def _categorical(logits, generator):
    """Gumbel-max draw of one index per row (as jax.random.categorical)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits + gumbel).argmax(dim=-1)


def sample(step_fn, init_carry, batch_size: int, seq_length: int,
           vocab_width: int, *, sample_max: bool = True, temperature: float = 1.0,
           generator=None, greedy_mask=None):
    """Roll out seq_length tokens for a batch.

    step_fn: (tokens (B,), carry) -> (logprobs (B, V+1), carry).
    generator: torch.Generator for the categorical draws (a seeded one on
      the carry's device is made when None).
    greedy_mask: optional (B,) bool; True rows decode greedily, the rest
      draw, in one loop (overrides sample_max per row).
    """
    B, L = batch_size, seq_length
    device = tree_leaves(init_carry)[0].device
    if generator is None and (greedy_mask is not None or not sample_max):
        generator = torch.Generator(device=device).manual_seed(0)
    state = init_carry
    prev_lp = torch.zeros((B, vocab_width), device=device)
    unfinished = torch.zeros((B,), dtype=torch.bool, device=device)
    toks, lps, all_lps = [], [], []
    for t in range(L + 1):
        if greedy_mask is not None:
            drawn = _categorical(prev_lp / temperature, generator)
            it_raw = torch.where(greedy_mask, prev_lp.argmax(dim=-1), drawn)
        elif sample_max:
            it_raw = prev_lp.argmax(dim=-1)
        else:
            it_raw = _categorical(prev_lp / temperature, generator)
        samp_lp = prev_lp.gather(1, it_raw[:, None])[:, 0]
        if t == 0:
            it_raw = torch.zeros_like(it_raw)  # BOS
        new_unfinished = it_raw > 0 if t <= 1 else unfinished & (it_raw > 0)
        it_masked = it_raw * new_unfinished
        lp, state = step_fn(it_raw, state)
        if t >= 1:
            # record while some row was still unfinished before this step
            # (the reference breaks out of its loop once all rows finished)
            alive = unfinished.any() if t > 1 else torch.ones((), dtype=torch.bool,
                                                                device=device)
            toks.append(torch.where(alive, it_masked, 0))
            lps.append(torch.where(alive, samp_lp, 0.0))
        all_lps.append(lp)
        prev_lp, unfinished = lp, new_unfinished
    return SampleOut(seq=torch.stack(toks, dim=1), seq_logprobs=torch.stack(lps, dim=1),
                     logprobs_all=torch.stack(all_lps, dim=1))
