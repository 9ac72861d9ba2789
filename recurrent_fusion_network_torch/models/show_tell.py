"""ShowTellModel: the NIC baseline.

Counterpart of ``recurrent_fusion_network_tpu/models/show_tell.py``: the
image's fc feature, embedded, is the step-0 input of a stack of bias-free
LSTM layers (the step's output is dropped); later steps take token
embeddings. The image step runs inside ``encode``, so every decode engine
sees the same (memory=None, state) interface. Dropout applies between
layers only, drawn from the caller's ``torch.Generator``.

The initial state is an f32 zero state, as in the JAX package: with bf16
weights the recurrent state and the logits are f32 (``promoted_matmul``).
The model reads no attention features; ``encode`` takes any ``att_feats``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..ops import cells
from ..ops.initializers import apply_linear, linear
from .base import EncodeOut, embed_tokens, init_embed_logit, single_encoder, xe_decode


@dataclasses.dataclass(frozen=True)
class ShowTellModel:
    vocab_size: int
    seq_length: int
    input_encoding_size: int = 512
    rnn_size: int = 512
    num_layers: int = 1
    drop_prob_lm: float = 0.0
    fc_feat_size: int = 2048

    @classmethod
    def from_opt(cls, opt):
        if getattr(opt, "low_rank_ctx", 0):
            raise ValueError("--low_rank_ctx is a recurrent_fusion_model variant; "
                             "show_tell has no attention path")
        fc = (opt.feat_array_info[0]["fc_feat_size"] if opt.feat_array_info
              else opt.fc_feat_size)
        return cls(
            vocab_size=opt.vocab_size,
            seq_length=opt.seq_length,
            input_encoding_size=opt.input_encoding_size,
            rnn_size=opt.rnn_size,
            num_layers=opt.num_layers,
            drop_prob_lm=opt.drop_prob_lm,
            fc_feat_size=fc,
        )

    # ------------------------------------------------------------------ params

    def init_params(self, generator, *, device=None):
        """Random f32 parameters in the JAX package's tree layout (a
        ``torch.Generator`` on ``device``; None only on "meta")."""
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            raise ValueError("init_params needs a torch.Generator")
        embed, logit = init_embed_logit(generator, self.vocab_size,
                                        self.input_encoding_size, self.rnn_size,
                                        device=dev)
        core = [cells.plain_lstm_init(
            generator, self.input_encoding_size if l == 0 else self.rnn_size,
            self.rnn_size, device=dev) for l in range(self.num_layers)]
        return {
            # img_embed keeps the nn.Linear default init
            "img_embed": linear(generator, self.fc_feat_size, self.input_encoding_size,
                                weight="default", device=dev),
            "embed": embed,
            "logit": logit,
            "core": core,
        }

    # -------------------------------------------------------------------- core

    def _core(self, params, xt, state, generator, training):
        """The stacked bias-free LSTM; dropout between layers."""
        new_state = []
        h = xt
        for l, (layer, st) in enumerate(zip(params["core"], state)):
            h, st = cells.plain_lstm_step(layer, h, st, rnn_size=self.rnn_size)
            new_state.append(st)
            if l < self.num_layers - 1:
                h = cells.maybe_dropout(h, self.drop_prob_lm, generator, training)
        return h, tuple(new_state)

    # ------------------------------------------------------------- public API

    def embed(self, params, tokens):
        return embed_tokens(params, tokens)

    def encode(self, params, fc_feats, att_feats=None, *, generator=None,
               training=False):
        """The image step; its state conditions decoding. fc_feats: (B, D)
        or a sequence of one."""
        fc = single_encoder(fc_feats)
        xt = apply_linear(params["img_embed"], fc)
        z = torch.zeros((fc.shape[0], self.rnn_size), device=fc.device)
        _, state = self._core(params, xt, tuple((z, z) for _ in range(self.num_layers)),
                              generator, training)
        return EncodeOut(memory=None, state=state, reason_preds=[])

    def decode_logits(self, params, xt, memory, state, *, generator=None,
                      training=False):
        h, state = self._core(params, xt, state, generator, training)
        return cells.promoted_matmul(h, params["logit"]["w"]) + params["logit"]["b"], state

    def decode_logprobs(self, params, xt, memory, state, *, generator=None,
                        training=False):
        logits, state = self.decode_logits(params, xt, memory, state,
                                           generator=generator, training=training)
        return torch.log_softmax(logits.float(), dim=-1), state

    def forward(self, params, fc_feats, att_feats, seq, *, ss_prob=0.0,
                generator=None, training=False):
        """Teacher-forced pass over seq[:, :L+1] -> (log-probs (B, L+1, V+1)
        f32, [])."""
        enc = self.encode(params, fc_feats, att_feats, generator=generator,
                          training=training)
        lps = xe_decode(
            lambda xt, state, rand: self.decode_logprobs(
                params, xt, None, state, generator=rand, training=training),
            lambda toks: self.embed(params, toks), enc.state,
            seq[:, : self.seq_length + 1], ss_prob=ss_prob, generator=generator)
        return lps, []
