"""RFNet (Jiang et al., ECCV 2018) and ReviewNet (Yang et al., NIPS 2016),
forward passes in plain PyTorch.

Weights come as a flat dict {"a.b.c": tensor} in the layout the models
publish their trees in: linear layers ``{name}.w`` (in, out) and
``{name}.b``, applied as x @ w + b; per-step weights stacked on a leading
step axis. Equations:

  attention   s = tanh(K + q) v + b_v over the A positions, w = softmax(s),
              z = sum_a w_a X_a; K = X W_k + b_k (the keys, shared by all
              steps: tied keys), q = h W_q + b_q.
  LSTM        gates [i | f | o | g] = the cell's input sums; i, f, o
              sigmoid, g tanh; c' = f c + i g, h' = o tanh(c'); dropout on
              h' (inverted, keep masks handed in), which is both the output
              and the recurrent h.
  RFNet       stage I: encoder j starts from h = c = fc2h_j(fc_j); at each
              of S0 steps its cell reads H = [h_1 .. h_M] and its own
              attention over X_j; reason logits of each output, max over
              the steps. States then averaged over the encoders. Stage II:
              S steps of one cell reading h and M attentions, head m over
              encoder m's S0 thoughts; reason logits, max over steps.
              Decoder: an attention LSTM over stage II's S thoughts with the
              embedded previous token; log-softmax in f32.
  ReviewNet   h = c = fc2h(fc); S review steps of a cell reading h and its
              attention over X; reason logits, max over steps; the same
              decoder over the S thoughts.

``prec`` is the arithmetic the matrix products run in: ``F32`` (IEEE f32),
``Quantized`` (each operand rounded to fp8 e4m3 first, per-tensor scale:
the serving cells' control) or ``TF32`` (the training cells' control where
there is no card).
"""

from __future__ import annotations

import torch


class F32:
    def mm(self, x, w):
        return x @ w

    def act(self, x):
        return x


class Quantized(F32):
    """Operands of every product rounded to fp8 e4m3 with a per-tensor
    scale (max |x| to 448), the products then taken in f32."""

    def act(self, x):
        s = x.detach().abs().amax().clamp_min(1e-12) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    def mm(self, x, w):
        return self.act(x) @ self.act(w)


def tf32(x):
    """x rounded to TF32: the f32 mantissa cut to 10 bits, to nearest even."""
    i = x.detach().float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """x @ w with every operand rounded to TF32, the gradients' products
    too, accumulated in f32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return tf32(x) @ tf32(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = tf32(g)
        gx = g @ tf32(w).transpose(-1, -2)
        gw = tf32(x).transpose(-1, -2) @ g
        # a broadcast operand's gradient sums over the axes it was broadcast on
        while gx.dim() > x.dim():
            gx = gx.sum(0)
        while gw.dim() > w.dim():
            gw = gw.sum(0)
        return gx.sum_to_size(x.shape), gw.sum_to_size(w.shape)


class TF32(F32):
    """Products in TF32, for a machine that has no TF32 arithmetic."""

    def mm(self, x, w):
        return _TF32Product.apply(x, w)


class Drops:
    """Dropout keep masks, consumed in the order the cells run; each a
    full-batch (N, R) bool mask, of which ``rows`` are used. None: no
    dropout."""

    def __init__(self, masks=None, rows=None):
        self.masks, self.rows, self.pos = masks, rows, 0

    def apply(self, h, rate):
        if self.masks is None or rate <= 0.0:
            return h
        m = self.masks[self.pos]
        self.pos += 1
        if self.rows is not None:
            m = m[self.rows]
        return torch.where(m, h / (1.0 - rate), torch.zeros_like(h))


def linear(P, name, x, prec, step=None, head=None):
    w, b = P[name + ".w"], P.get(name + ".b")
    if step is not None:
        w, b = w[step], None if b is None else b[step]
    if head is not None:
        w, b = w[head], None if b is None else b[head]
    y = prec.mm(x, w)
    return y if b is None else y + b


def attend(q, keys, v, bv, values, prec):
    """q (N, H), keys (N, A, H), v (H,), bv (), values (N, A, D) -> z (N, D)."""
    e = torch.tanh(prec.act(keys) + prec.act(q)[:, None, :])
    s = prec.mm(e, v[:, None])[..., 0] + bv
    w = torch.softmax(s, dim=-1)
    return prec.mm(w[:, None, :], values)[:, 0, :]


def lstm(sums, c, R):
    i = torch.sigmoid(sums[:, :R])
    f = torch.sigmoid(sums[:, R:2 * R])
    o = torch.sigmoid(sums[:, 2 * R:3 * R])
    g = torch.tanh(sums[:, 3 * R:4 * R])
    c2 = f * c + i * g
    return o * torch.tanh(c2), c2


def rfnet_encode(P, cfg, fcs, atts, drops, rates, prec):
    """-> (thoughts (B, S, R), (h, c), reason logits: M + 1 heads)."""
    M, R = len(cfg["encoders"]), cfg["rnn_size"]
    S0, S = cfg["num_review_steps_0"], cfg["num_review_steps"]
    h = [linear(P, f"fc2h.{j}", fcs[j], prec) for j in range(M)]
    c = list(h)
    keys = [linear(P, f"review1_keys.{j}", atts[j], prec) for j in range(M)]
    outs = [[] for _ in range(M)]
    reasons = [[] for _ in range(M)]
    for s in range(S0):
        H = torch.cat(h, dim=1)
        nh, nc = [], []
        for j in range(M):
            a = f"review1.{j}.att."
            q = linear(P, a + "h_2_att_h", h[j], prec, step=s)
            z = attend(q, keys[j], P[a + "att_h_2_out.w"][s][:, 0],
                       P[a + "att_h_2_out.b"][s][0], atts[j], prec)
            sums = (linear(P, f"review1.{j}.H2h", H, prec, step=s)
                    + linear(P, f"review1.{j}.z2h", z, prec, step=s))
            h2, c2 = lstm(sums, c[j], R)
            h2 = drops.apply(h2, rates["fusion"])
            nh.append(h2)
            nc.append(c2)
            outs[j].append(h2)
            reasons[j].append(linear(P, f"reason_individual.{j}", h2, prec))
        h, c = nh, nc
    reason_preds = [torch.stack(r).amax(dim=0) for r in reasons]
    hb, cb = sum(h) / M, sum(c) / M
    T1 = torch.stack([torch.stack(o, dim=1) for o in outs])  # (M, B, S0, R)
    keys2 = [linear(P, "review2_keys", T1[m], prec, head=m) for m in range(M)]
    comb, creasons = [], []
    for s in range(S):
        sums = linear(P, "review2.h2h", hb, prec, step=s)
        for m in range(M):
            q = linear(P, "review2.att.h_2_att_h", hb, prec, step=s, head=m)
            z = attend(q, keys2[m], P["review2.att.att_h_2_out.w"][s][m][:, 0],
                       P["review2.att.att_h_2_out.b"][s][m][0], T1[m], prec)
            sums = sums + linear(P, "review2.z_2_h", z, prec, step=s, head=m)
        hb, cb = lstm(sums, cb, R)
        hb = drops.apply(hb, rates["reason"])
        comb.append(hb)
        creasons.append(linear(P, "reason_linear", hb, prec))
    reason_preds.append(torch.stack(creasons).amax(dim=0))
    return torch.stack(comb, dim=1), (hb, cb), reason_preds


def reviewnet_encode(P, cfg, fcs, atts, drops, rates, prec):
    R, S = cfg["rnn_size"], cfg["num_review_steps"]
    fc, att = fcs[0], atts[0]
    h = linear(P, "fc2h", fc, prec)
    c = h
    keys = linear(P, "review_keys", att, prec)
    outs, reasons = [], []
    for s in range(S):
        q = linear(P, "review.att.h_2_att_h", h, prec, step=s)
        z = attend(q, keys, P["review.att.att_h_2_out.w"][s][:, 0],
                   P["review.att.att_h_2_out.b"][s][0], att, prec)
        sums = (linear(P, "review.h2h", h, prec, step=s)
                + linear(P, "review.z2h", z, prec, step=s))
        h, c = lstm(sums, c, R)
        h = drops.apply(h, rates["reason"])
        outs.append(h)
        reasons.append(linear(P, "reason_linear", h, prec))
    return torch.stack(outs, dim=1), (h, c), [torch.stack(reasons).amax(dim=0)]


ENCODERS = {"recurrent_fusion_model": rfnet_encode, "review_net": reviewnet_encode}


class Decoder:
    """The attention-LSTM decoder over ``thoughts`` (N, S, R)."""

    def __init__(self, P, cfg, thoughts, prec):
        self.P, self.R, self.prec = P, cfg["rnn_size"], prec
        self.thoughts = thoughts
        self.keys = linear(P, "decoder.att.att_2_att_h", thoughts, prec)

    def step(self, tokens, h, c, drops=None, rate=0.0):
        """-> (log-probs (N, V+1) f32, h, c)."""
        P, prec = self.P, self.prec
        x = P["embed"][tokens]
        q = linear(P, "decoder.att.h_2_att_h", h, prec)
        z = attend(q, self.keys, P["decoder.att.att_h_2_out.w"][:, 0],
                   P["decoder.att.att_h_2_out.b"][0], self.thoughts, prec)
        sums = (linear(P, "decoder.i2h", x, prec) + linear(P, "decoder.h2h", h, prec)
                + linear(P, "decoder.z2h", z, prec))
        h2, c2 = lstm(sums, c, self.R)
        if drops is not None:
            h2 = drops.apply(h2, rate)
        logits = linear(P, "logit", h2, prec)
        return torch.log_softmax(logits.float(), dim=-1), h2, c2


def teacher_forced(P, cfg, fcs, atts, seq_in, prec, drops=None, rates=None):
    """-> (log-probs (N, T, V+1), reason logits) over seq_in (N, T), column 0
    the BOS token 0."""
    rates = rates or {"fusion": 0.0, "reason": 0.0, "lm": 0.0}
    drops = drops or Drops()
    thoughts, (h, c), reasons = ENCODERS[cfg["model"]](P, cfg, fcs, atts, drops, rates, prec)
    dec = Decoder(P, cfg, thoughts, prec)
    lps = []
    for t in range(seq_in.shape[1]):
        lp, h, c = dec.step(seq_in[:, t], h, c, drops, rates["lm"])
        lps.append(lp)
    return torch.stack(lps, dim=1), reasons


NEG = -1e30


def _top(x, k):
    """The k largest along dim 1, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


@torch.no_grad()
def beam_search(P, cfg, fcs, atts, K, prec):
    """Beam search of width ``K`` over B images -> (seq (B, L), its summed
    log-prob (B,)).

    Token 0 is BOS and EOS. At the first choice only beam 0 is live; a beam
    whose last token is 0 is finished and offers no candidates. At each
    step the K best (beam sum + token log-prob) over the live beams' tokens
    are kept; those that chose 0, and at the last step all K, are offered
    to the K best finished captions, which keep their sums. The answer is
    the best finished caption. Ties go to the lower index, finished
    captions before new ones."""
    L = cfg["seq_length"]
    thoughts, (h, c), _ = ENCODERS[cfg["model"]](P, cfg, fcs, atts, Drops(),
                                                 {"fusion": 0.0, "reason": 0.0, "lm": 0.0},
                                                 prec)
    B, dev = thoughts.shape[0], thoughts.device
    rep = lambda x: torch.repeat_interleave(x, K, dim=0)  # noqa: E731
    dec = Decoder(P, cfg, rep(thoughts), prec)
    h, c = rep(h), rep(c)
    lp, h, c = dec.step(torch.zeros(B * K, dtype=torch.long, device=dev), h, c)
    V = lp.shape[1]
    seqs = torch.zeros((B, K, L), dtype=torch.long, device=dev)
    sums = torch.zeros((B, K), device=dev)
    last = torch.ones((B, K), dtype=torch.long, device=dev)
    done_seq = torch.zeros((B, K, L), dtype=torch.long, device=dev)
    done_p = torch.full((B, K), NEG, device=dev)
    for t in range(1, L + 1):
        scores = sums[:, :, None] + lp.view(B, K, V)
        if t == 1:
            scores[:, 1:] = NEG
        else:
            scores = scores.masked_fill((last == 0)[:, :, None], NEG)
        vals, idx = _top(scores.reshape(B, K * V), K)
        parent, token = idx // V, idx % V
        seqs = seqs.gather(1, parent[:, :, None].expand(B, K, L)).clone()
        seqs[:, :, t - 1] = token
        offered = vals if t == L else torch.where(token == 0, vals, torch.full_like(vals, NEG))
        done_p, keep = _top(torch.cat([done_p, offered], dim=1), K)
        done_seq = torch.cat([done_seq, seqs], dim=1).gather(1, keep[:, :, None].expand(B, K, L))
        if t == L:
            break
        lanes = (torch.arange(B, device=dev)[:, None] * K + parent).reshape(-1)
        lp, h, c = dec.step(token.reshape(-1), h.index_select(0, lanes), c.index_select(0, lanes))
        sums, last = vals, token
    return done_seq[:, 0], done_p[:, 0]
