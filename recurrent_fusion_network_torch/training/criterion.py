"""Criterion dispatch of the XE and SCST steps.

Counterpart of ``recurrent_fusion_network_tpu/training/criterion.py``
(``make_criterion``, ``make_rl_criterion``): ShowTell trains on the XE or
the SCST loss alone, ReviewNet adds the reason loss of its one head, RFNet
the reason loss averaged over its M+1 heads.
"""

from __future__ import annotations

from ..ops import losses

MODELS = ("show_tell", "review_net", "recurrent_fusion_model")


def _check_model(opt) -> str:
    if opt.caption_model not in MODELS:
        raise ValueError(f"caption_model not supported: {opt.caption_model}")
    return opt.caption_model


def make_criterion(opt):
    """-> crit(log_prob, labels, masks, reason_preds, top_words) -> loss.

    labels / masks are the full (B, L+2) arrays; the criterion takes
    labels[:, 1:] and masks[:, 1:].
    """
    model_name = _check_model(opt)
    smoothing = dict(use_label_smoothing=bool(opt.use_label_smoothing),
                     label_smoothing_epsilon=opt.label_smoothing_epsilon)
    max_targets = (opt.seq_length or 16) + 2
    reason_weight = opt.reason_weight

    def crit(log_prob, labels, masks, reason_preds, top_words):
        target, mask = labels[:, 1:], masks[:, 1:]
        if model_name == "show_tell":
            return losses.language_model_loss(log_prob, target, mask, **smoothing)
        if model_name == "review_net":
            return losses.review_net_loss(log_prob, target, mask, reason_preds[0],
                                          top_words, reason_weight,
                                          max_targets=max_targets, **smoothing)
        return losses.review_net_ensemble_loss(
            log_prob, target, mask, list(reason_preds), top_words, reason_weight,
            max_targets=max_targets, **smoothing)

    return crit


def make_rl_criterion(opt):
    """-> crit(sample_logprobs, seq, reward, logprobs_all, reason_preds,
    top_words, sample_logprobs_old=None) -> loss: the SCST loss, plus for
    ReviewNet the reason loss of its head and for RFNet the reason loss
    averaged over its M+1 heads."""
    model_name = _check_model(opt)
    max_targets = (opt.seq_length or 16) + 2
    ppo = dict(use_ppo=bool(opt.use_ppo), ppo_clip=opt.ppo_clip)

    def crit(sample_logprobs, seq, reward, logprobs_all, reason_preds, top_words,
             sample_logprobs_old=None):
        if model_name == "show_tell":
            return losses.reward_loss(sample_logprobs, seq, reward, logprobs_all,
                                      opt.entropy_reg, sample_logprobs_old, **ppo)
        top_pred = reason_preds[0] if model_name == "review_net" else list(reason_preds)
        return losses.review_net_reward_loss(
            sample_logprobs, seq, reward, logprobs_all, opt.entropy_reg, top_pred,
            top_words, opt.reason_weight, sample_logprobs_old, max_targets=max_targets,
            **ppo)

    return crit
