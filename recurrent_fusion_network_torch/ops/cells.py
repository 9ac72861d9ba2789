"""Single-step LSTM cells.

Counterpart of ``recurrent_fusion_network_tpu/ops/cells.py``: the five
cells, all sharing one gate layout (preactivation chunks [in | forget |
out | g], sigmoid on the first 3R, tanh -- or maxout over two chunks -- on
the last):

  att_lstm        decoder cell: i2h(x) + h2h(h) + z2h(z)
  no_input_lstm   ReviewNet review cell: h2h(h) + z2h(z)
  fusion_lstm     stage-I cell: H2h(H) + z2h(z), H = every encoder's h
  multi_att_lstm  stage-II cell: h2h(h) + sum_i z_2_h[i](z_i) over M heads
  plain_lstm      ShowTell's bias-free cell: i2h(x) + h2h(h), no attention

Every attention read goes through ``ops/attention.py`` and so through the
additive-attention kernels, forward and backward. State is a plain
``(h, c)`` tuple of (B, R) tensors. In training, dropout is applied to
next_h before it is returned as both the output and the recurrent state
(``maybe_dropout``, drawn from an explicit ``torch.Generator``).
"""

from __future__ import annotations

import math

import torch

from . import attention
from .initializers import apply_linear, linear, stack_params, uniform


def maybe_dropout(x, rate: float, generator, training: bool):
    """Inverted dropout: x / keep where kept, 0 elsewhere. Draws nothing
    unless training with rate > 0."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def lstm_update(all_input_sums, pre_c, rnn_size: int, maxout: bool):
    """Gate math shared by every cell variant."""
    R = rnn_size
    sig = torch.sigmoid(all_input_sums[:, : 3 * R])
    in_gate, forget_gate, out_gate = sig[:, :R], sig[:, R : 2 * R], sig[:, 2 * R :]
    if maxout:
        in_transform = torch.maximum(all_input_sums[:, 3 * R : 4 * R],
                                     all_input_sums[:, 4 * R : 5 * R])
    else:
        in_transform = torch.tanh(all_input_sums[:, 3 * R : 4 * R])
    next_c = forget_gate * pre_c + in_gate * in_transform
    next_h = out_gate * torch.tanh(next_c)
    return next_h, next_c


def _gate_dim(rnn_size: int, maxout: bool) -> int:
    return (5 if maxout else 4) * rnn_size


# --------------------------------------------------------------- att_lstm


def att_lstm_init(generator, input_encoding_size, rnn_size, att_feat_size,
                  att_hid_size, maxout=False, *, device):
    g = _gate_dim(rnn_size, maxout)
    return {
        "att": attention.init(generator, rnn_size, att_feat_size, att_hid_size,
                              bias="uniform", device=device),
        "i2h": linear(generator, input_encoding_size, g, bias="uniform", device=device),
        "h2h": linear(generator, rnn_size, g, bias="uniform", device=device),
        "z2h": linear(generator, att_feat_size, g, bias="uniform", device=device),
    }


def att_lstm_step(params, xt, att_feats, state, *, keys=None, mask=None,
                  rnn_size: int, maxout: bool = False, drop_rate: float = 0.0,
                  generator=None, training: bool = False):
    pre_h, pre_c = state
    z, _ = attention.attend(params["att"], pre_h, att_feats, keys=keys, mask=mask)
    sums = (apply_linear(params["i2h"], xt) + apply_linear(params["h2h"], pre_h)
            + apply_linear(params["z2h"], z))
    next_h, next_c = lstm_update(sums, pre_c, rnn_size, maxout)
    next_h = maybe_dropout(next_h, drop_rate, generator, training)
    return next_h, (next_h, next_c)


# ---------------------------------------------------------- no_input_lstm


def no_input_lstm_init(generator, rnn_size, att_feat_size, att_hid_size, maxout=False,
                       *, device):
    """ReviewNet's review cell: constant bias fills, 0.0 on the attention and
    -1.0 on h2h / z2h."""
    g = _gate_dim(rnn_size, maxout)
    return {
        "att": attention.init(generator, rnn_size, att_feat_size, att_hid_size,
                              bias=0.0, device=device),
        "h2h": linear(generator, rnn_size, g, bias=-1.0, device=device),
        "z2h": linear(generator, att_feat_size, g, bias=-1.0, device=device),
    }


def no_input_lstm_step(params, att_feats, state, *, keys=None, mask=None,
                       rnn_size: int, maxout: bool = False, drop_rate: float = 0.0,
                       generator=None, training: bool = False):
    pre_h, pre_c = state
    z, _ = attention.attend(params["att"], pre_h, att_feats, keys=keys, mask=mask)
    sums = apply_linear(params["h2h"], pre_h) + apply_linear(params["z2h"], z)
    next_h, next_c = lstm_update(sums, pre_c, rnn_size, maxout)
    next_h = maybe_dropout(next_h, drop_rate, generator, training)
    return next_h, (next_h, next_c)


# ------------------------------------------------------------ fusion_lstm


def fusion_lstm_init(generator, H_size, rnn_size, att_feat_size, att_hid_size,
                     maxout=False, ctx_size=None, *, device):
    """ctx_size: width of the attention context z2h consumes; defaults to
    att_feat_size (low_rank_ctx passes rnn_size)."""
    g = _gate_dim(rnn_size, maxout)
    return {
        "att": attention.init(generator, rnn_size, att_feat_size, att_hid_size,
                              bias="uniform", device=device),
        "H2h": linear(generator, H_size, g, bias="default", device=device),
        "z2h": linear(generator, ctx_size or att_feat_size, g, bias="default",
                      device=device),
    }


def fusion_lstm_step(params, H, att_feats, state, *, keys=None, mask=None,
                     rnn_size: int, maxout: bool = False, drop_rate: float = 0.0,
                     generator=None, training: bool = False):
    """One fusion step: the cell sees the concatenated hidden states H of all
    encoders plus attention over its own encoder's features."""
    pre_h, pre_c = state
    z, _ = attention.attend(params["att"], pre_h, att_feats, keys=keys, mask=mask)
    sums = apply_linear(params["H2h"], H) + apply_linear(params["z2h"], z)
    next_h, next_c = lstm_update(sums, pre_c, rnn_size, maxout)
    next_h = maybe_dropout(next_h, drop_rate, generator, training)
    return next_h, (next_h, next_c)


# --------------------------------------------------------- multi_att_lstm


def multi_att_lstm_init(generator, rnn_size, att_feat_size, num_feat_array,
                        att_hid_size, maxout=False, *, device):
    """All M attention heads / z-projections are stacked on a leading M axis."""
    g = _gate_dim(rnn_size, maxout)
    atts = [attention.init(generator, rnn_size, att_feat_size, att_hid_size,
                           bias="uniform", device=device)
            for _ in range(num_feat_array)]
    z2hs = [linear(generator, att_feat_size, g, weight="default", bias="default",
                   device=device)
            for _ in range(num_feat_array)]
    return {
        "h2h": linear(generator, rnn_size, g, bias="uniform", device=device),
        "att": stack_params(atts),
        "z_2_h": stack_params(z2hs),
    }


def multi_att_lstm_step(params, att_feats_stack, state, *, keys_stack=None,
                        mask=None, rnn_size: int, maxout: bool = False,
                        drop_rate: float = 0.0, generator=None, training: bool = False):
    """att_feats_stack: (M, B, A, D) homogeneous feature sets; the M reads
    are one kernel launch (M head groups)."""
    pre_h, pre_c = state
    z_stack, _ = attention.attend_heads(params["att"], pre_h, att_feats_stack,
                                        keys_stack=keys_stack, mask=mask)
    sums = apply_linear(params["h2h"], pre_h)
    sums = sums + torch.einsum("mbd,mdg->bg", z_stack, params["z_2_h"]["w"])
    sums = sums + params["z_2_h"]["b"].sum(dim=0)
    next_h, next_c = lstm_update(sums, pre_c, rnn_size, maxout)
    next_h = maybe_dropout(next_h, drop_rate, generator, training)
    return next_h, (next_h, next_c)


# ------------------------------------------------------------- plain_lstm


def plain_lstm_init(generator, input_size, rnn_size, *, device):
    """A bias-free LSTM layer (ShowTell's core), both weights
    U(-1/sqrt(R), 1/sqrt(R))."""
    bound = 1.0 / math.sqrt(rnn_size)
    return {"i2h": {"w": uniform(generator, (input_size, 4 * rnn_size), bound,
                                 device=device)},
            "h2h": {"w": uniform(generator, (rnn_size, 4 * rnn_size), bound,
                                 device=device)}}


def promoted_matmul(x, w):
    """x @ w under the JAX package's dtype promotion: a bf16 operand meets an
    f32 one in f32. ShowTell starts from an f32 zero state, so with bf16
    weights its recurrent state and logits are f32, as in the JAX package."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def plain_lstm_step(params, xt, state, *, rnn_size: int):
    pre_h, pre_c = state
    sums = (promoted_matmul(xt, params["i2h"]["w"])
            + promoted_matmul(pre_h, params["h2h"]["w"]))
    next_h, next_c = lstm_update(sums, pre_c, rnn_size, maxout=False)
    return next_h, (next_h, next_c)
