"""Additive (Bahdanau / show-attend-tell) soft attention.

Counterpart of ``recurrent_fusion_network_tpu/ops/attention.py``:
score = v . tanh(Wa att + Wh h), softmax over spatial positions, context =
weighted sum of features. The key projection ``Wa att`` and the query
``Wh h`` are plain matrix products; the rest of the read (tanh, score,
softmax, weighted sum) is the hand-written kernel pair of
``kernels/additive_attention.py``, differentiable through its
``AdditiveAttentionFn``: on a CUDA tensor each direction launches its
kernel or raises.
"""

from __future__ import annotations

import torch

from ..kernels.additive_attention import NEG_INF, additive_attention
from .initializers import apply_linear, linear

__all__ = ["NEG_INF", "init", "precompute_keys", "attend", "attend_heads"]


def init(generator, rnn_size: int, att_feat_size: int, att_hid_size: int, *,
         bias="uniform", device):
    return {
        "att_2_att_h": linear(generator, att_feat_size, att_hid_size, bias=bias,
                              device=device),
        "h_2_att_h": linear(generator, rnn_size, att_hid_size, bias=bias,
                            device=device),
        "att_h_2_out": linear(generator, att_hid_size, 1, bias=bias, device=device),
    }


def precompute_keys(params, att_feats):
    """Project spatial features once: (B, A, D) -> (B, A, H)."""
    return apply_linear(params["att_2_att_h"], att_feats)


def _rows_mask(mask, rows: int, A: int):
    """(B, A) or (A,) bool mask -> contiguous (rows, A), rows a multiple of B."""
    if mask is None:
        return None
    mask = mask.to(torch.bool)
    if mask.dim() == 1:
        return mask.expand(rows, A).contiguous()
    return mask.repeat(rows // mask.shape[0], 1).contiguous()


def attend(params, h, att_feats, keys=None, mask=None):
    """One attention read.

    h: (B, R); att_feats: (B, A, D); keys: optional precomputed (B, A, H);
    mask: optional (B, A) or (A,) bool, False positions excluded.
    Returns z (B, D) and weights (B, A).
    """
    if keys is None:
        keys = precompute_keys(params, att_feats)
    q = apply_linear(params["h_2_att_h"], h)  # (B, H)
    out = params["att_h_2_out"]  # w (H, 1), b (1,)
    B, A, _ = keys.shape
    return additive_attention(
        q.contiguous(), keys.contiguous(), out["w"].reshape(1, -1).contiguous(),
        out["b"].reshape(1).contiguous(), att_feats.contiguous(),
        _rows_mask(mask, B, A))


def attend_heads(params, h, feats_stack, keys_stack=None, mask=None):
    """M homogeneous attention heads over M feature sets, one kernel launch
    each way (M head groups).

    params: attention params stacked on a leading M axis; h: (B, R) shared
    query state; feats_stack: (M, B, A, D); keys_stack: optional
    (M, B, A, H). Returns z (M, B, D) and weights (M, B, A).
    """
    M, B, A, D = feats_stack.shape
    if keys_stack is None:
        kp = params["att_2_att_h"]
        keys_stack = (torch.einsum("mbad,mdh->mbah", feats_stack, kp["w"])
                      + kp["b"][:, None, None, :])
    qp = params["h_2_att_h"]
    q = torch.einsum("br,mrh->mbh", h, qp["w"]) + qp["b"][:, None, :]
    H = q.shape[-1]
    out = params["att_h_2_out"]  # w (M, H, 1), b (M, 1)
    z, w = additive_attention(
        q.reshape(M * B, H).contiguous(),
        keys_stack.reshape(M * B, A, H).contiguous(),
        out["w"].reshape(M, H).contiguous(), out["b"].reshape(M).contiguous(),
        feats_stack.reshape(M * B, A, D).contiguous(),
        _rows_mask(mask, M * B, A))
    return z.view(M, B, D), w.view(M, B, A)
