"""Step-function factories shared by the decode engines.

A step function has signature ``step_fn(tokens, carry) -> (logprobs,
carry)``: ``tokens`` is (N,) int64, ``logprobs`` is (N, V+1) f32 normalized
log-probabilities, and every leaf of ``carry`` has the lane dimension on
axis 0 (the beam engine gathers lanes along it).
"""

from __future__ import annotations


def make_step_fn(model, params, memory):
    """Single-model eval-mode step function."""

    def step_fn(tokens, state):
        xt = model.embed(params, tokens)
        return model.decode_logprobs(params, xt, memory, state)

    return step_fn
