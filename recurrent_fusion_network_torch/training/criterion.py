"""Criterion dispatch of the XE step.

Counterpart of ``recurrent_fusion_network_tpu/training/criterion.py::
make_criterion``. This slice of the port trains the RFNet model only.
"""

from __future__ import annotations

from ..ops import losses


def make_criterion(opt):
    """-> crit(log_prob, labels, masks, reason_preds, top_words) -> loss.

    labels / masks are the full (B, L+2) arrays; the criterion takes
    labels[:, 1:] and masks[:, 1:].
    """
    if opt.caption_model in ("show_tell", "review_net"):
        raise NotImplementedError(
            f"the {opt.caption_model} criterion is not ported yet (ROADMAP.md "
            "queue 1, M8 other models)")
    if opt.caption_model != "recurrent_fusion_model":
        raise ValueError(f"caption_model not supported: {opt.caption_model}")
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
