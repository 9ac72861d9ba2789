"""Mixture-of-Softmax output head (Yang et al. 2017, arXiv:1711.03953).

Counterpart of ``recurrent_fusion_network_tpu/ops/mos.py``: a softmax prior
over ``n_experts``, a tanh latent projection per expert, a shared decoder
and a mixture of the experts' softmaxes. The experts' latent layers are
stacked on a leading E axis and read by one einsum. Everything runs in the
parameters' dtype, as in the JAX package; only ``log_apply``'s log is f32.
"""

from __future__ import annotations

import torch

from .initializers import linear, stack_params


def init(generator, rnn_size: int, emb_size: int, n_experts: int, dict_size: int, *,
         device):
    latents = [linear(generator, rnn_size, emb_size, weight="default", bias="default",
                      device=device) for _ in range(n_experts)]
    return {
        "prior": linear(generator, rnn_size, n_experts, weight="default", bias=None,
                        device=device),
        "latent": stack_params(latents),  # leading axis E
        "decoder": linear(generator, emb_size, dict_size, weight="default",
                          bias="default", device=device),
    }


def apply(params, output):
    """output: (B, R) -> mixture probabilities (B, V)."""
    prior = torch.softmax(output @ params["prior"]["w"], dim=-1)  # (B, E)
    latent = torch.tanh(torch.einsum("br,erm->ebm", output, params["latent"]["w"])
                        + params["latent"]["b"][:, None, :])
    logits = (torch.einsum("ebm,mv->ebv", latent, params["decoder"]["w"])
              + params["decoder"]["b"])
    probs = torch.softmax(logits, dim=-1)  # (E, B, V)
    return torch.einsum("ebv,be->bv", probs, prior)


def log_apply(params, output, eps: float = 1e-12):
    """log of the mixture probability, f32; eps guards log(0)."""
    return torch.log(apply(params, output).float() + eps)
