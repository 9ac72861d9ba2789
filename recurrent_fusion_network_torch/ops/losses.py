"""Training criterions of the XE and SCST steps.

Counterpart of ``recurrent_fusion_network_tpu/ops/losses.py``:

  language_model_loss       masked XE with optional label smoothing
  multilabel_margin_loss    torch.nn.MultiLabelMarginLoss semantics with the
                            JAX package's static target truncation
  review_net_ensemble_loss  XE + the reason loss averaged over RFNet's M+1
                            reason heads
  reward_loss               the SCST policy-gradient loss (optionally PPO's
                            clipped surrogate) with the entropy term
  review_net_reward_loss    reward_loss + the averaged reason loss

Every loss divides by the batch size B, not by the mask sum. The equations
are the JAX package's, so dtypes follow its promotion: log-probabilities
arrive in f32, reason heads in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def language_model_loss(log_prob, target, mask, *, use_label_smoothing=False,
                        label_smoothing_epsilon=0.1):
    """log_prob: (B, T, V); target: (B, >=T) ids; mask: (B, >=T). Target
    and mask are cut to T."""
    B, T, V = log_prob.shape
    target = target[:, :T]
    mask = mask[:, :T].to(log_prob.dtype)
    if use_label_smoothing:
        one_hot = F.one_hot(target, V).to(log_prob.dtype)
        smoothed = one_hot * (1.0 - label_smoothing_epsilon) + label_smoothing_epsilon / V
        nll = -(log_prob * smoothed).sum(dim=2) * mask
    else:
        picked = log_prob.gather(2, target[..., None])[..., 0]
        nll = -picked * mask
    return nll.sum() / B


def multilabel_margin_loss(x, y, *, max_targets=None):
    """torch.nn.MultiLabelMarginLoss ('mean' reduction) of scores x (B, C)
    and -1-padded targets y (B, K), with y cut to its first ``max_targets``
    columns as the JAX package does (``F.multilabel_margin_loss`` keeps
    every valid target, so the two differ once a row has more)."""
    B, C = x.shape
    if max_targets is not None and y.shape[1] > max_targets:
        y = y[:, :max_targets]
    valid = torch.cumprod((y >= 0).to(torch.int32), dim=1).bool()  # (B, K)
    y_safe = torch.where(valid, y, torch.zeros_like(y))
    one_hot = F.one_hot(y_safe, C).to(x.dtype) * valid[..., None]
    is_target = one_hot.sum(dim=1).clamp(0.0, 1.0)  # (B, C)
    x_target = x.gather(1, y_safe)  # (B, K)
    margin = torch.relu(1.0 - x_target[:, :, None] + x[:, None, :])  # (B, K, C)
    margin = margin * valid[:, :, None] * (1.0 - is_target)[:, None, :]
    per_sample = margin.sum(dim=(1, 2)) / C
    return per_sample.mean()


def review_net_ensemble_loss(log_prob, target, mask, top_pred_list, top_true,
                             reason_weight, *, use_label_smoothing=False,
                             label_smoothing_epsilon=0.1, max_targets=None):
    """XE + the reason loss averaged over the M+1 reason heads."""
    xe = language_model_loss(log_prob, target, mask,
                             use_label_smoothing=use_label_smoothing,
                             label_smoothing_epsilon=label_smoothing_epsilon)
    disc = sum(multilabel_margin_loss(tp, top_true, max_targets=max_targets)
               for tp in top_pred_list)
    return xe + disc * reason_weight / len(top_pred_list)


# ---------------------------------------------------------------- SCST


def _rl_masks(seq):
    """mask_0 = seq > 0; mask = [1, mask_0[:, :-1]]: one step more, so the
    EOS step is rewarded."""
    mask_0 = (seq > 0).to(torch.float32)
    mask = torch.cat([torch.ones_like(mask_0[:, :1]), mask_0[:, :-1]], dim=1)
    return mask_0, mask


def _entropy_term(logprobs_all, mask_0, T):
    """sum_v p log p per step, masked by mask_0."""
    lp = logprobs_all[:, :T, :]
    return (lp * torch.exp(lp)).sum(dim=2) * mask_0


def reward_loss(sample_logprobs, seq, reward, logprobs_all, entropy_reg,
                sample_logprobs_old=None, *, use_ppo=False, ppo_clip=0.2):
    """SCST policy-gradient loss with the entropy term.

    sample_logprobs: (B, T) log-prob of each sampled token; seq: (B, T)
    sampled ids, 0 once finished; reward: (B, T); logprobs_all: (B, >=T, V)
    per-step log-distributions. With use_ppo, the clipped surrogate clamps
    the ratio exp(a) / (1e-5 + exp(b)), the reference's form: the epsilon
    shrinks the ratio of tokens with log-prob below ln(1e-5), kept for
    parity with the JAX package.
    """
    B, T = sample_logprobs.shape
    mask_0, mask = _rl_masks(seq)
    if use_ppo:
        if sample_logprobs_old is None:
            raise ValueError("use_ppo=True requires sample_logprobs_old (the frozen "
                             "rollout log-probs of make_rl_step's old_logprobs)")
        ratio = torch.exp(sample_logprobs) / (1e-5 + torch.exp(sample_logprobs_old))
        surr1 = ratio * reward
        surr2 = torch.clamp(ratio, 1.0 - ppo_clip, 1.0 + ppo_clip) * reward
        out = -torch.minimum(surr1, surr2) * mask
    else:
        out = -sample_logprobs * reward * mask
    ent = _entropy_term(logprobs_all, mask_0, T)
    return out.sum() / B + entropy_reg * ent.sum() / B


def review_net_reward_loss(sample_logprobs, seq, reward, logprobs_all, entropy_reg,
                           top_pred, top_true, reason_weight, sample_logprobs_old=None,
                           *, use_ppo=False, ppo_clip=0.2, max_targets=None):
    """SCST loss + the reason loss; ``top_pred`` is one (B, C) head or a
    list of them (RFNet's M+1 heads, averaged)."""
    base = reward_loss(sample_logprobs, seq, reward, logprobs_all, entropy_reg,
                       sample_logprobs_old, use_ppo=use_ppo, ppo_clip=ppo_clip)
    if isinstance(top_pred, (list, tuple)):
        disc = sum(multilabel_margin_loss(tp, top_true, max_targets=max_targets)
                   for tp in top_pred) / len(top_pred)
    else:
        disc = multilabel_margin_loss(top_pred, top_true, max_targets=max_targets)
    return base + disc * reason_weight
