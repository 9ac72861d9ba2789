"""RecurrentFusionModel: the paper's model (Jiang et al., ECCV 2018).

Counterpart of ``recurrent_fusion_network_tpu/models/recurrent_fusion.py``:

  stage I   per-encoder fc -> h init states; ``num_review_steps_0`` untied
            fusion steps, where every encoder's LSTM sees the concatenation H
            of all encoders' hidden states plus attention over its own
            spatial features, emitting thought vectors and reason logits;
  stage II  states averaged across encoders, then ``num_review_steps``
            untied multi-attention steps over the M thought-vector sets;
  decoder   attention-LSTM over the combined thought vectors with a
            log-softmax (in f32) output.

Per-step untied weights are stacked on a leading step axis, as in the JAX
package, and the JAX scans become Python loops over that axis. Three
profiles share the code: tied attention keys (the default), untied keys
(``--reference_parity``) and ``low_rank_ctx``. ``forward`` is the
teacher-forced training pass; with ``training=True`` the cells apply
dropout drawn from the caller's ``torch.Generator``. With ``use_remat``
each stage-I and stage-II review step and each XE decode step is
rematerialised (``models/base.py::remat_wrap``), as the JAX package wraps
its scan steps; a step's dropout masks are drawn before it runs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..device import resolve_device
from ..ops import attention, cells
from ..ops.initializers import apply_linear, index_params, linear, stack_params
from .base import (EncodeOut, embed_tokens, init_embed_logit, resolve_tied, review_step,
                   xe_decode)


@dataclasses.dataclass(frozen=True)
class RecurrentFusionModel:
    vocab_size: int
    seq_length: int
    fc_feat_sizes: Tuple[int, ...]
    att_feat_sizes: Tuple[int, ...]
    att_nums: Tuple[int, ...]
    input_encoding_size: int = 512
    rnn_size: int = 512
    att_hid_size: int = 512
    drop_prob_lm: float = 0.0
    drop_prob_reason: float = 0.0
    drop_prob_fusion: float = 0.0
    num_review_steps: int = 8
    num_review_steps_0: int = 8
    top_words_count: int = 1000
    review_maxout: bool = False
    decoder_maxout: bool = False
    fusion_maxout: bool = False
    # rematerialise the review steps and the XE decode in the backward
    # (models/base.py::remat_wrap, policy "save_ctx" or "full")
    use_remat: bool = False
    remat_policy: str = "save_ctx"
    tied_att_keys: bool = False
    low_rank_ctx: bool = False

    @property
    def num_feat_array(self) -> int:
        return len(self.fc_feat_sizes)

    @classmethod
    def from_opt(cls, opt):
        feats = opt.feat_array_info
        return cls(
            vocab_size=opt.vocab_size,
            seq_length=opt.seq_length,
            fc_feat_sizes=tuple(f["fc_feat_size"] for f in feats),
            att_feat_sizes=tuple(f["att_feat_size"] for f in feats),
            att_nums=tuple(f["att_num"] for f in feats),
            input_encoding_size=opt.input_encoding_size,
            rnn_size=opt.rnn_size,
            att_hid_size=opt.att_hid_size,
            drop_prob_lm=opt.drop_prob_lm,
            drop_prob_reason=opt.drop_prob_reason,
            drop_prob_fusion=opt.drop_prob_fusion,
            num_review_steps=opt.num_review_steps,
            num_review_steps_0=opt.num_review_steps_0,
            top_words_count=opt.top_words_count,
            review_maxout=bool(opt.review_maxout),
            decoder_maxout=bool(opt.maxout),
            fusion_maxout=bool(opt.fusion_maxout),
            use_remat=bool(getattr(opt, "use_remat", 0)),
            remat_policy=str(getattr(opt, "remat_policy", "save_ctx") or "save_ctx"),
            tied_att_keys=resolve_tied(opt),
            low_rank_ctx=bool(getattr(opt, "low_rank_ctx", 0)),
        )

    # ------------------------------------------------------------------ params

    def init_params(self, generator, *, device=None):
        """Random f32 parameters in the JAX package's tree layout, drawn from
        ``generator`` (a ``torch.Generator`` on ``device``; None only on the
        "meta" device, where no values are drawn)."""
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            raise ValueError("init_params needs a torch.Generator")
        M, R, Hd = self.num_feat_array, self.rnn_size, self.att_hid_size
        g = generator
        fc2h = [linear(g, self.fc_feat_sizes[i], R, bias="default", device=dev)
                for i in range(M)]
        embed, logit = init_embed_logit(g, self.vocab_size, self.input_encoding_size,
                                        R, device=dev)
        review1, review1_keys, value_proj = [], [], []
        for i in range(M):
            step_cells = [
                cells.fusion_lstm_init(
                    g, M * R, R, self.att_feat_sizes[i], Hd,
                    maxout=self.fusion_maxout,
                    ctx_size=R if self.low_rank_ctx else None, device=dev)
                for _ in range(self.num_review_steps_0)
            ]
            if self.low_rank_ctx:
                value_proj.append(linear(g, self.att_feat_sizes[i], R,
                                         bias="uniform", device=dev))
            if self.tied_att_keys:
                for c in step_cells:
                    del c["att"]["att_2_att_h"]
                review1_keys.append(linear(g, self.att_feat_sizes[i], Hd,
                                           bias="uniform", device=dev))
            review1.append(stack_params(step_cells))
        reason_individual = [linear(g, R, self.top_words_count, bias="default",
                                    device=dev) for _ in range(M)]
        step_cells2 = [
            cells.multi_att_lstm_init(g, R, R, M, Hd, maxout=self.review_maxout,
                                      device=dev)
            for _ in range(self.num_review_steps)
        ]
        if self.tied_att_keys:
            for c in step_cells2:
                del c["att"]["att_2_att_h"]
        params = {
            "fc2h": fc2h,
            "embed": embed,
            "logit": logit,
            "review1": tuple(review1),  # M trees, leading axis R0
            "reason_individual": tuple(reason_individual),
            "review2": stack_params(step_cells2),  # leading axis S (then M)
            "reason_linear": linear(g, R, self.top_words_count, bias="default",
                                    device=dev),
            "decoder": cells.att_lstm_init(g, self.input_encoding_size, R, R, Hd,
                                           maxout=self.decoder_maxout, device=dev),
        }
        if self.tied_att_keys:
            params["review1_keys"] = tuple(review1_keys)
            params["review2_keys"] = stack_params(
                [linear(g, R, Hd, bias="uniform", device=dev) for _ in range(M)])
        if self.low_rank_ctx:
            params["value_proj"] = tuple(value_proj)
        return params

    # ------------------------------------------------------------- public API

    def embed(self, params, tokens):
        return embed_tokens(params, tokens)

    def encode(self, params, fc_feats, att_feats, *, generator=None, training=False):
        """fc_feats / att_feats: sequences of M tensors, (B, D_j) and
        (B, A_j, D_j)."""
        M, R = self.num_feat_array, self.rnn_size
        if len(fc_feats) != M or len(att_feats) != M:
            raise ValueError(f"expected {M} encoders' features")
        states = [(h, h) for h in (apply_linear(params["fc2h"][i], fc_feats[i])
                                   for i in range(M))]

        # h-independent attention keys, hoisted out of the step loop: one
        # projection per encoder (tied) or one per encoder and step (untied)
        keys1 = []
        for j in range(M):
            if self.tied_att_keys:
                keys1.append(attention.precompute_keys(
                    {"att_2_att_h": params["review1_keys"][j]}, att_feats[j]))
            else:
                a = params["review1"][j]["att"]["att_2_att_h"]
                keys1.append(torch.einsum("bad,sdh->sbah", att_feats[j], a["w"])
                             + a["b"][:, None, None, :])
        if self.low_rank_ctx:
            values = [apply_linear(params["value_proj"][j], att_feats[j])
                      for j in range(M)]
        else:
            values = list(att_feats)

        # ---- stage I: interacting fusion review
        def stage1(s, states, rand):
            H = torch.cat([st[0] for st in states], dim=1)  # (B, M*R)
            outs, reasons, new_states = [], [], []
            for j in range(M):
                out, st = cells.fusion_lstm_step(
                    index_params(params["review1"][j], s), H, values[j], states[j],
                    keys=keys1[j] if self.tied_att_keys else keys1[j][s],
                    rnn_size=R, maxout=self.fusion_maxout,
                    drop_rate=self.drop_prob_fusion, generator=rand, training=training)
                outs.append(out)
                reasons.append(apply_linear(params["reason_individual"][j], out))
                new_states.append(st)
            return new_states, outs, reasons

        step1 = review_step(stage1, self, n_cells=M, rate=self.drop_prob_fusion,
                            generator=generator, training=training, like=fc_feats[0])
        outs = [[] for _ in range(M)]
        reasons = [[] for _ in range(M)]
        for s in range(self.num_review_steps_0):
            states, step_outs, step_reasons = step1(s, states)
            for j in range(M):
                outs[j].append(step_outs[j])
                reasons[j].append(step_reasons[j])
        thoughts_i = [torch.stack(o, dim=1) for o in outs]  # M x (B, R0, R)
        reason_preds = [torch.stack(r).amax(dim=0) for r in reasons]

        # ---- average states across encoders
        state = (sum(st[0] for st in states) / M, sum(st[1] for st in states) / M)

        # ---- stage II: multi-attention combine
        thought_stack = torch.stack(thoughts_i, dim=0)  # (M, B, R0, R)
        if self.tied_att_keys:
            kw = params["review2_keys"]  # w: (M, R, H)
            keys2 = (torch.einsum("mbar,mrh->mbah", thought_stack, kw["w"])
                     + kw["b"][:, None, None, :])
        else:
            a2 = params["review2"]["att"]["att_2_att_h"]  # w: (S, M, R, H)
            keys2 = (torch.einsum("mbar,smrh->smbah", thought_stack, a2["w"])
                     + a2["b"][:, :, None, None, :])

        def stage2(s, state, rand):
            out, state = cells.multi_att_lstm_step(
                index_params(params["review2"], s), thought_stack, state,
                keys_stack=keys2 if self.tied_att_keys else keys2[s],
                rnn_size=R, maxout=self.review_maxout,
                drop_rate=self.drop_prob_reason, generator=rand, training=training)
            return state, out, apply_linear(params["reason_linear"], out)

        step2 = review_step(stage2, self, n_cells=1, rate=self.drop_prob_reason,
                            generator=generator, training=training, like=fc_feats[0])
        comb_outs, comb_reasons = [], []
        for s in range(self.num_review_steps):
            state, out, reason = step2(s, state)
            comb_outs.append(out)
            comb_reasons.append(reason)
        thoughts_comb = torch.stack(comb_outs, dim=1)  # (B, S, R)
        reason_preds.append(torch.stack(comb_reasons).amax(dim=0))

        memory = {
            "thoughts": thoughts_comb,
            "keys": attention.precompute_keys(params["decoder"]["att"], thoughts_comb),
        }
        return EncodeOut(memory=memory, state=state, reason_preds=reason_preds)

    def decode_logits(self, params, xt, memory, state, *, generator=None,
                      training=False):
        out, state = cells.att_lstm_step(
            params["decoder"], xt, memory["thoughts"], state, keys=memory["keys"],
            rnn_size=self.rnn_size, maxout=self.decoder_maxout,
            drop_rate=self.drop_prob_lm, generator=generator, training=training)
        return apply_linear(params["logit"], out), state

    def decode_logprobs(self, params, xt, memory, state, *, generator=None,
                        training=False):
        logits, state = self.decode_logits(params, xt, memory, state,
                                           generator=generator, training=training)
        return torch.log_softmax(logits.float(), dim=-1), state

    def forward(self, params, fc_feats, att_feats, seq, *, ss_prob=0.0,
                generator=None, training=False):
        """Teacher-forced pass over seq[:, :L+1] -> (log-probs (B, L+1, V+1)
        f32, the M+1 reason heads)."""
        enc = self.encode(params, fc_feats, att_feats, generator=generator,
                          training=training)
        rows, device = fc_feats[0].shape[0], fc_feats[0].device
        lps = xe_decode(
            lambda xt, state, rand: self.decode_logprobs(
                params, xt, enc.memory, state, generator=rand, training=training),
            lambda toks: self.embed(params, toks), enc.state,
            seq[:, : self.seq_length + 1], ss_prob=ss_prob, generator=generator,
            remat=self.use_remat, remat_policy=self.remat_policy,
            step_draws=lambda g: cells.dropout_masks(
                g, [(rows, self.rnn_size)], self.drop_prob_lm, training, device=device))
        return lps, enc.reason_preds
