"""The XE training step, written out: the teacher-forced pass, the
criterion, the gradient, then the elementwise clamp, coupled weight decay
and Adam.

Criterion (per batch of N caption rows, B of them images x captions):
  XE     sum over rows and the L + 1 steps of the mask-weighted negative
         log-likelihood, the target smoothed by eps (one-hot (1 - eps) +
         eps / (V + 1)), divided by N;
  reason the multi-label margin loss of each of the model's reason heads
         against the row's top words (the distinct top-word ids of its
         caption, sorted, the first L + 2 kept): per row sum over targets
         k and non-targets c of max(0, 1 - x_k + x_c) / C, mean over
         rows; averaged over the heads, times reason_weight.
Optimizer: g <- clamp(g, -clip, clip) + wd * p; Adam with bias-corrected
moments, eps outside the square root; p <- p - lr * direction.

The batch is taken in blocks of images so that the plain attention's
(rows, A, H) activations fit beside the weights; the block's losses are
divided by the whole batch's N, so the summed gradients are the batch's.
"""

from __future__ import annotations

import torch

from .models import Drops, F32, teacher_forced


def top_targets(labels, top_words_count: int, max_targets: int):
    """(N, L+2) zero-bordered labels -> (N, K) top-word ids, -1 padded:
    word id i in 1..top_words_count is top word i - 1."""
    rows = []
    for r in labels.tolist():
        ids = sorted({t - 1 for t in r if 1 <= t <= top_words_count})[:max_targets]
        rows.append(ids)
    K = max(1, max(len(r) for r in rows))
    out = torch.full((len(rows), K), -1, dtype=torch.long)
    for i, r in enumerate(rows):
        out[i, :len(r)] = torch.tensor(r, dtype=torch.long)
    return out


def margin_loss_sum(x, y):
    """Sum over rows of the multi-label margin loss: x (n, C) scores,
    y (n, K) target ids, -1 padded."""
    n, C = x.shape
    valid = y >= 0
    ys = torch.where(valid, y, torch.zeros_like(y))
    is_t = torch.zeros((n, C + 1), dtype=torch.bool, device=x.device)
    is_t[torch.arange(n, device=x.device)[:, None], torch.where(valid, y, C)] = True
    is_t = is_t[:, :C]  # column C took the padding
    xt = x.gather(1, ys)  # (n, K)
    m = torch.relu(1.0 - xt[:, :, None] + x[:, None, :])
    m = m * valid[:, :, None] * (~is_t)[:, None, :]
    return m.sum() / C


def block_loss(P, cfg, hyper, fcs, atts, labels, masks, tops, n_total, drops, prec):
    L = cfg["seq_length"]
    lps, reasons = teacher_forced(P, cfg, fcs, atts, labels[:, :L + 1], prec, drops,
                                  hyper["rates"])
    T = lps.shape[1]
    target, mask = labels[:, 1:T + 1], masks[:, 1:T + 1]
    eps = hyper["label_smoothing"]
    V1 = lps.shape[2]
    picked = lps.gather(2, target[..., None])[..., 0]
    if eps > 0:
        nll = -((1.0 - eps) * picked + (eps / V1) * lps.sum(dim=2))
    else:
        nll = -picked
    xe = (nll * mask).sum() / n_total
    reason = sum(margin_loss_sum(r, tops) for r in reasons) / n_total / len(reasons)
    return xe + hyper["reason_weight"] * reason


def draw_masks(generator, n_rows, cfg, hyper, device):
    """One step's dropout keep masks, full batch, in the order the cells
    run: stage I (steps x encoders), stage II (steps), decoder (L + 1)."""
    R, r = cfg["rnn_size"], hyper["rates"]
    order = []
    if cfg["model"] == "recurrent_fusion_model":
        order += [r["fusion"]] * (cfg["num_review_steps_0"] * len(cfg["encoders"]))
    order += [r["reason"]] * cfg["num_review_steps"]
    order += [r["lm"]] * (cfg["seq_length"] + 1)
    return [torch.rand((n_rows, R), generator=generator, device=device) < 1.0 - rate
            for rate in order if rate > 0.0]


def run_steps(P0, cfg, hyper, batches, generator, prec=F32(), block_images=100):
    """Train ``len(batches)`` XE steps from the weights ``P0`` (flat dict,
    consumed: updated in place). batches: callables -> (fcs, atts, labels,
    masks, tops) on the device, image-major rows. -> dict(losses, grads:
    {name: first step's gradient as Adam gets it, norm}, changes: {name:
    norm of p - p0 after the steps}, grad_median)."""
    names = list(P0)
    start = {k: v.detach().clone() for k, v in P0.items()}
    P = {k: v.detach().requires_grad_() for k, v in P0.items()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    spi = hyper["captions_per_image"]
    losses, grads0 = [], None
    for step, batch in enumerate(batches, start=1):
        fcs, atts, labels, masks, tops = batch()
        N = labels.shape[0]
        drops_all = draw_masks(generator, N, cfg, hyper, labels.device)
        total = 0.0
        for lo in range(0, N, block_images * spi):
            rows = torch.arange(lo, min(N, lo + block_images * spi), device=labels.device)
            imgs = torch.div(rows[::spi], spi, rounding_mode="floor")
            f = [torch.repeat_interleave(x[imgs], spi, dim=0) for x in fcs]
            a = [torch.repeat_interleave(x[imgs], spi, dim=0) for x in atts]
            loss = block_loss(P, cfg, hyper, f, a, labels[rows], masks[rows], tops[rows], N,
                              Drops(drops_all or None, rows), prec)
            loss.backward()
            total += float(loss.detach())
            del loss
        losses.append(total)
        g0 = adam_update(P, mu, nu, step, hyper)
        grads0 = grads0 or g0
    with torch.no_grad():
        changes = {k: float(torch.linalg.vector_norm(P[k] - start[k])) for k in names}
    return {"losses": losses, "grads": grads0, "changes": changes}


@torch.no_grad()
def adam_update(P, mu, nu, step, hyper):
    """Clamp, weight decay and Adam's step ``step`` on every leaf of ``P``
    from its accumulated .grad (cleared). -> {name: norm of the gradient
    as Adam took it}."""
    b1, b2, eps = hyper["b1"], hyper["b2"], hyper["eps"]
    norms = {}
    for k, p in P.items():
        g = p.grad
        g.clamp_(-hyper["grad_clip"], hyper["grad_clip"])
        if hyper["weight_decay"]:
            g.add_(p, alpha=hyper["weight_decay"])
        norms[k] = float(torch.linalg.vector_norm(g))
        mu[k].mul_(b1).add_(g, alpha=1 - b1)
        nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (nu[k] / (1 - b2 ** step)).sqrt_().add_(eps)
        p.sub_(hyper["lr"] * (mu[k] / (1 - b1 ** step)) / denom)
        p.grad = None
    return norms
