"""The SCST iteration, written out: the rollout's choices, the reward, the
policy-gradient step.

Rollout: one encode of the batch's rows, then 2N lanes (the N rows twice):
the first N draw each token by Gumbel-max, argmax(lp + g), g = -log(-log u)
with u uniform, one (2N, V + 1) draw of u at each of the L + 1 steps
(the first, which feeds BOS, included), from the run's generator; the
other N take argmax(lp). A row is done after its first 0. The judge
teacher-forces the program's tokens through the reference decoder and
reads, for each token through the row's EOS, by how much its score lies
below the best score the reference gives at that step (0 where the program
chose as the reference would; near 0 at near-ties).

Reward: CIDEr-D of each sampled row against its image's captions minus
that of its greedy row, the same over every step.

Step: the teacher-forced log-probs of the sampled tokens, loss = -sum(lp
reward mask) / N + entropy_reg sum(p log p mask0) / N (mask0 = token > 0,
mask = [1, mask0[:-1]]), plus the reason loss as in XE; its gradient, the
clamp, weight decay and Adam of ``xe``.
"""

from __future__ import annotations

import torch

from .models import Decoder, Drops, ENCODERS, F32, teacher_forced
from .xe import adam_update, margin_loss_sum

NO_DROP = {"fusion": 0.0, "reason": 0.0, "lm": 0.0}


def _through_eos(seq):
    """(n, L) bool: the tokens through each row's first 0."""
    z = (seq == 0).int()
    before = torch.cumsum(z, dim=1) - z  # zeros strictly before each position
    return before == 0


@torch.no_grad()
def rollout_gap(P, cfg, fcs, atts, seq, greedy, generator, prec):
    """The widest gap, over the program's rollout tokens through EOS, of the
    reference's best score at that step above the score of the program's
    token (sampled rows with their Gumbel noise, greedy rows without).
    Consumes the iteration's L + 1 draws from ``generator``."""
    N, L = seq.shape
    thoughts, (h, c), _ = ENCODERS[cfg["model"]](P, cfg, fcs, atts, Drops(), NO_DROP, prec)
    dec = Decoder(P, cfg, torch.cat([thoughts, thoughts]), prec)
    h, c = torch.cat([h, h]), torch.cat([c, c])
    toks = torch.cat([seq, greedy])  # (2N, L)
    live = _through_eos(toks)
    sampled = torch.arange(2 * N, device=seq.device) < N
    gap = 0.0
    lp = None
    for t in range(L + 1):
        u = torch.rand((2 * N, cfg["vocab_size"] + 1), generator=generator,
                       device=seq.device)
        if t >= 1:
            g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
            score = torch.where(sampled[:, None], lp + g, lp)
            chosen = score.gather(1, toks[:, t - 1:t])[:, 0]
            below = score.amax(dim=1) - chosen
            m = live[:, t - 1]
            if m.any():
                gap = max(gap, float(below[m].max()))
        if t == L:
            break
        inp = torch.zeros(2 * N, dtype=torch.long, device=seq.device) if t == 0 \
            else toks[:, t - 1]
        lp, h, c = dec.step(inp, h, c)
    return gap


def block_loss(P, cfg, hyper, fcs, atts, seq, reward, tops, n_total, prec):
    N, L = seq.shape
    seq_in = torch.zeros((N, L + 1), dtype=torch.long, device=seq.device)
    seq_in[:, 1:] = seq
    lps, reasons = teacher_forced(P, cfg, fcs, atts, seq_in, prec)
    slp = lps[:, :L].gather(2, seq[..., None])[..., 0]
    mask0 = (seq > 0).float()
    mask = torch.cat([torch.ones_like(mask0[:, :1]), mask0[:, :-1]], dim=1)
    pg = -(slp * reward[:, None] * mask).sum() / n_total
    ent = ((lps[:, :L] * torch.exp(lps[:, :L])).sum(dim=2) * mask0).sum() / n_total
    reason = sum(margin_loss_sum(r, tops) for r in reasons) / n_total / len(reasons)
    return pg + hyper["entropy_reg"] * ent + hyper["reason_weight"] * reason


def run_iterations(P0, cfg, hyper, iterations, generator, cider, prec=F32(),
                   block_images=100):
    """SCST iterations from ``P0`` (flat dict, updated in place) on the
    program's rollouts. iterations: callables -> (fcs, atts per image, tops
    (N, K), sampled (N, L), greedy (N, L), captions per image). -> dict(
    rollout_gap, rewards: per iteration (N,) float64, losses, grads,
    changes)."""
    names = list(P0)
    start = {k: v.detach().clone() for k, v in P0.items()}
    P = {k: v.detach().requires_grad_() for k, v in P0.items()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    spi = hyper["captions_per_image"]
    losses, rewards, grads0, gap = [], [], None, 0.0
    for step, it in enumerate(iterations, start=1):
        fcs, atts, tops, seq, greedy, caps = it()
        N = seq.shape[0]
        rows_f = [torch.repeat_interleave(x, spi, dim=0) for x in fcs]
        rows_a = [torch.repeat_interleave(x, spi, dim=0) for x in atts]
        Pd = {k: v.detach() for k, v in P.items()}
        gap = max(gap, rollout_gap(Pd, cfg, rows_f, rows_a, seq, greedy, generator, prec))
        del rows_f, rows_a
        refs = [caps[i // spi] for i in range(N)]
        s_np, g_np = seq.cpu().numpy(), greedy.cpu().numpy()
        r = cider.scores(list(s_np), refs) - cider.scores(list(g_np), refs)
        rewards.append(r)
        reward = torch.as_tensor(r, dtype=torch.float32, device=seq.device)
        total = 0.0
        for lo in range(0, N, block_images * spi):
            rows = torch.arange(lo, min(N, lo + block_images * spi), device=seq.device)
            imgs = torch.div(rows[::spi], spi, rounding_mode="floor")
            f = [torch.repeat_interleave(x[imgs], spi, dim=0) for x in fcs]
            a = [torch.repeat_interleave(x[imgs], spi, dim=0) for x in atts]
            loss = block_loss(P, cfg, hyper, f, a, seq[rows], reward[rows], tops[rows], N, prec)
            loss.backward()
            total += float(loss.detach())
            del loss
        losses.append(total)
        g0 = adam_update(P, mu, nu, step, hyper)
        grads0 = grads0 or g0
    with torch.no_grad():
        changes = {k: float(torch.linalg.vector_norm(P[k] - start[k])) for k in names}
    return {"rollout_gap": gap, "rewards": rewards, "losses": losses, "grads": grads0,
            "changes": changes}
