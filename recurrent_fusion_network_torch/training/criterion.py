"""Criterion dispatch of the XE and SCST steps.

Counterpart of ``recurrent_fusion_network_tpu/training/criterion.py``
(``make_criterion``, ``make_rl_criterion``). This slice of the port trains
the RFNet model only.
"""

from __future__ import annotations

from ..ops import losses


def _rfnet_only(opt) -> None:
    if opt.caption_model in ("show_tell", "review_net"):
        raise NotImplementedError(
            f"the {opt.caption_model} criterion is not ported yet (ROADMAP.md "
            "queue 1, M8 other models)")
    if opt.caption_model != "recurrent_fusion_model":
        raise ValueError(f"caption_model not supported: {opt.caption_model}")


def make_criterion(opt):
    """-> crit(log_prob, labels, masks, reason_preds, top_words) -> loss.

    labels / masks are the full (B, L+2) arrays; the criterion takes
    labels[:, 1:] and masks[:, 1:].
    """
    _rfnet_only(opt)
    use_ls = bool(opt.use_label_smoothing)
    eps = opt.label_smoothing_epsilon
    max_targets = (opt.seq_length or 16) + 2
    reason_weight = opt.reason_weight

    def crit(log_prob, labels, masks, reason_preds, top_words):
        return losses.review_net_ensemble_loss(
            log_prob, labels[:, 1:], masks[:, 1:], list(reason_preds), top_words,
            reason_weight, use_label_smoothing=use_ls, label_smoothing_epsilon=eps,
            max_targets=max_targets)

    return crit


def make_rl_criterion(opt):
    """-> crit(sample_logprobs, seq, reward, logprobs_all, reason_preds,
    top_words, sample_logprobs_old=None) -> loss: the SCST loss with the
    reason loss averaged over RFNet's M+1 heads."""
    _rfnet_only(opt)
    max_targets = (opt.seq_length or 16) + 2

    def crit(sample_logprobs, seq, reward, logprobs_all, reason_preds, top_words,
             sample_logprobs_old=None):
        return losses.review_net_reward_loss(
            sample_logprobs, seq, reward, logprobs_all, opt.entropy_reg,
            list(reason_preds), top_words, opt.reason_weight, sample_logprobs_old,
            use_ppo=bool(opt.use_ppo), ppo_clip=opt.ppo_clip, max_targets=max_targets)

    return crit
