"""Step-function factories shared by the decode engines.

A step function has signature ``step_fn(tokens, carry) -> (logprobs,
carry)``: ``tokens`` is (N,) int64, ``logprobs`` is (N, V+1) f32 normalized
log-probabilities, and every leaf of ``carry`` has the lane dimension on
axis 0 (the beam engine gathers lanes along it).
"""

from __future__ import annotations

import torch


def make_step_fn(model, params, memory):
    """Single-model eval-mode step function."""

    def step_fn(tokens, state):
        xt = model.embed(params, tokens)
        return model.decode_logprobs(params, xt, memory, state)

    return step_fn


def make_ensemble_step_fn(members):
    """Ensemble step: the f32 mean of the members' logits, then
    log-softmax (the reference's eval_utils.py:282-289).

    members: sequence of (model, params, memory) triples. The carry is a
    tuple of per-member states. A MoS member contributes its mixture
    PROBABILITIES (its ``decode_logits``), as the reference's one_time_step
    does: the quirk is kept for output parity, so a one-member MoS ensemble
    does not reduce to the solo decode's log-probs, and a MoS member mixed
    with others averages probabilities against raw logits.
    """

    def step_fn(tokens, states):
        total, new_states = None, []
        for (model, params, memory), state in zip(members, states):
            logits, state = model.decode_logits(params, model.embed(params, tokens),
                                                memory, state)
            total = logits.float() if total is None else total + logits.float()
            new_states.append(state)
        return torch.log_softmax(total / len(members), dim=-1), tuple(new_states)

    return step_fn
