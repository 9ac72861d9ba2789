"""ReviewNetModel: the Review Net captioner (Yang et al. 2016).

Counterpart of ``recurrent_fusion_network_tpu/models/review_net.py``: fc ->
h init, ``num_review_steps`` untied no-input attention-LSTM review cells
over the image's spatial features emitting thought vectors, a reason head
(top words, max over the review steps), an attention-LSTM decoder over the
thought vectors and, with ``use_mos``, a Mixture-of-Softmax output head.

The untied step weights are stacked on a leading step axis and the JAX scan
becomes a Python loop over it. The review cells' attention keys do not
depend on h, so they are projected once before the loop: one ``review_keys``
projection shared by every step (tied keys, the default) or one per step
(``--reference_parity``); the decoder's keys over the thought vectors are
projected once per image. Every attention read goes through the
additive-attention kernels (``ops/attention.py``). The dead ``logit`` head
stays in the tree under ``use_mos``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..ops import attention, cells, mos
from ..ops.initializers import apply_linear, index_params, linear, stack_params
from .base import (EncodeOut, embed_tokens, init_embed_logit, resolve_tied, review_step,
                   single_encoder, xe_decode)


@dataclasses.dataclass(frozen=True)
class ReviewNetModel:
    vocab_size: int
    seq_length: int
    input_encoding_size: int = 512
    rnn_size: int = 512
    att_hid_size: int = 512
    drop_prob_lm: float = 0.0
    drop_prob_reason: float = 0.0
    fc_feat_size: int = 2048
    att_feat_size: int = 2048
    att_num: int = 196
    num_review_steps: int = 8
    top_words_count: int = 1000
    review_maxout: bool = False
    decoder_maxout: bool = False
    use_mos: bool = False
    num_expert: int = 10
    # rematerialise the review steps and the XE decode in the backward
    # (models/base.py::remat_wrap, policy "save_ctx" or "full")
    use_remat: bool = False
    remat_policy: str = "save_ctx"
    tied_att_keys: bool = False

    @classmethod
    def from_opt(cls, opt):
        if getattr(opt, "low_rank_ctx", 0):
            raise ValueError("--low_rank_ctx is a recurrent_fusion_model variant; "
                             "review_net does not implement it")
        if opt.feat_array_info:
            info = opt.feat_array_info[0]
            fc, att, num = info["fc_feat_size"], info["att_feat_size"], info["att_num"]
        else:
            fc, att, num = opt.fc_feat_size, opt.att_feat_size, opt.att_num
        return cls(
            vocab_size=opt.vocab_size,
            seq_length=opt.seq_length,
            input_encoding_size=opt.input_encoding_size,
            rnn_size=opt.rnn_size,
            att_hid_size=opt.att_hid_size,
            drop_prob_lm=opt.drop_prob_lm,
            drop_prob_reason=opt.drop_prob_reason,
            fc_feat_size=fc,
            att_feat_size=att,
            att_num=num,
            num_review_steps=opt.num_review_steps,
            top_words_count=opt.top_words_count,
            review_maxout=bool(opt.review_maxout),
            decoder_maxout=bool(opt.maxout),
            use_mos=bool(opt.use_mos),
            num_expert=opt.num_expert,
            use_remat=bool(getattr(opt, "use_remat", 0)),
            remat_policy=str(getattr(opt, "remat_policy", "save_ctx") or "save_ctx"),
            tied_att_keys=resolve_tied(opt),
        )

    # ------------------------------------------------------------------ params

    def init_params(self, generator, *, device=None):
        """Random f32 parameters in the JAX package's tree layout (a
        ``torch.Generator`` on ``device``; None only on "meta")."""
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            raise ValueError("init_params needs a torch.Generator")
        g, R, Hd = generator, self.rnn_size, self.att_hid_size
        embed, logit = init_embed_logit(g, self.vocab_size, self.input_encoding_size, R,
                                        device=dev)
        step_cells = [cells.no_input_lstm_init(g, R, self.att_feat_size, Hd,
                                               maxout=self.review_maxout, device=dev)
                      for _ in range(self.num_review_steps)]
        if self.tied_att_keys:
            for c in step_cells:
                del c["att"]["att_2_att_h"]
        params = {
            "fc2h": linear(g, self.fc_feat_size, R, bias="default", device=dev),
            "embed": embed,
            "logit": logit,  # dead under use_mos, kept as in the JAX package
            "review": stack_params(step_cells),  # leading axis: review step
            "reason_linear": linear(g, R, self.top_words_count, bias="default",
                                    device=dev),
            "decoder": cells.att_lstm_init(g, self.input_encoding_size, R, R, Hd,
                                           maxout=self.decoder_maxout, device=dev),
        }
        if self.use_mos:
            params["mos"] = mos.init(g, R, R, self.num_expert, self.vocab_size + 1,
                                     device=dev)
        if self.tied_att_keys:
            params["review_keys"] = linear(g, self.att_feat_size, Hd, bias=0.0,
                                           device=dev)
        return params

    # ------------------------------------------------------------- public API

    def embed(self, params, tokens):
        return embed_tokens(params, tokens)

    def encode(self, params, fc_feats, att_feats, *, generator=None, training=False):
        """fc_feats (B, D) and att_feats (B, A, D), or sequences of one."""
        fc, att = single_encoder(fc_feats), single_encoder(att_feats)
        init_h = apply_linear(params["fc2h"], fc)
        state = (init_h, init_h)
        if self.tied_att_keys:
            keys = attention.precompute_keys({"att_2_att_h": params["review_keys"]}, att)
        else:
            a = params["review"]["att"]["att_2_att_h"]  # w: (S, D, H)
            keys = torch.einsum("bad,sdh->sbah", att, a["w"]) + a["b"][:, None, None, :]

        def review(s, state, rand):
            out, state = cells.no_input_lstm_step(
                index_params(params["review"], s), att, state,
                keys=keys if self.tied_att_keys else keys[s], rnn_size=self.rnn_size,
                maxout=self.review_maxout, drop_rate=self.drop_prob_reason,
                generator=rand, training=training)
            return state, out, apply_linear(params["reason_linear"], out)

        step = review_step(review, self, n_cells=1, rate=self.drop_prob_reason,
                           generator=generator, training=training, like=fc)
        outs, reasons = [], []
        for s in range(self.num_review_steps):
            state, out, reason = step(s, state)
            outs.append(out)
            reasons.append(reason)
        thoughts = torch.stack(outs, dim=1)  # (B, S, R)
        memory = {
            "thoughts": thoughts,
            "keys": attention.precompute_keys(params["decoder"]["att"], thoughts),
        }
        return EncodeOut(memory=memory, state=state,
                         reason_preds=[torch.stack(reasons).amax(dim=0)])

    def _decode_out(self, params, xt, memory, state, generator, training):
        return cells.att_lstm_step(
            params["decoder"], xt, memory["thoughts"], state, keys=memory["keys"],
            rnn_size=self.rnn_size, maxout=self.decoder_maxout,
            drop_rate=self.drop_prob_lm, generator=generator, training=training)

    def decode_logits(self, params, xt, memory, state, *, generator=None,
                      training=False):
        """The ensemble hook: logits, or under use_mos the mixture
        probabilities."""
        out, state = self._decode_out(params, xt, memory, state, generator, training)
        if self.use_mos:
            return mos.apply(params["mos"], out), state
        return apply_linear(params["logit"], out), state

    def decode_logprobs(self, params, xt, memory, state, *, generator=None,
                        training=False):
        out, state = self._decode_out(params, xt, memory, state, generator, training)
        if self.use_mos:
            return mos.log_apply(params["mos"], out), state
        return torch.log_softmax(apply_linear(params["logit"], out).float(), dim=-1), state

    def forward(self, params, fc_feats, att_feats, seq, *, ss_prob=0.0,
                generator=None, training=False):
        """Teacher-forced pass over seq[:, :L+1] -> (log-probs (B, L+1, V+1)
        f32, [the reason head])."""
        enc = self.encode(params, fc_feats, att_feats, generator=generator,
                          training=training)
        fc = single_encoder(fc_feats)
        lps = xe_decode(
            lambda xt, state, rand: self.decode_logprobs(
                params, xt, enc.memory, state, generator=rand, training=training),
            lambda toks: self.embed(params, toks), enc.state,
            seq[:, : self.seq_length + 1], ss_prob=ss_prob, generator=generator,
            remat=self.use_remat, remat_policy=self.remat_policy,
            step_draws=lambda g: cells.dropout_masks(
                g, [(fc.shape[0], self.rnn_size)], self.drop_prob_lm, training,
                device=fc.device))
        return lps, enc.reason_preds
