"""Options of the port's serving and training entry points.

The port's own copy of the parts of ``recurrent_fusion_network_tpu/
config.py`` and ``eval.py::merge_checkpoint_opt`` that serving and the XE
train step read: the flag names and defaults of the model options, the
serving options of the root ``serve.py`` (the serve CLI's flags), the XE
and SCST training options with the JAX package's defaults (``Options``
only: the training CLIs are not ported yet), and the checkpoint merge (the CLI wins for
runtime knobs, the checkpoint's saved opt for the architecture).
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Optional, Sequence


def _defaults() -> dict:
    return dict(
        # model options (the JAX package's defaults; a checkpoint's saved
        # opt overrides them)
        caption_model="recurrent_fusion_model",
        rnn_size=512,
        input_encoding_size=512,
        att_hid_size=512,
        num_review_steps=8,
        num_review_steps_0=8,
        top_words_count=1000,
        maxout=0,
        review_maxout=0,
        fusion_maxout=0,
        reference_parity=0,
        tied_att_keys=-1,  # -1 = auto: tied unless --reference_parity
        low_rank_ctx=0,
        beam_size=1,
        # checkpoint location
        model_path="",
        checkpoint_path="checkpoint",
        load_model_id="",
        rl_prefix=0,  # serve the rl_-prefixed (SCST) checkpoint
        rank=0,  # checkpoint rank (fleet seed index)
        # serving
        host="0.0.0.0",
        port=8080,
        serve_batch_size=16,
        serve_depth=2,
        drain_timeout=30.0,
        serve_dtype="bfloat16",
        device="cuda",
    )


def _train_defaults() -> dict:
    """XE and SCST training options, the JAX package's flag names and
    defaults."""
    return dict(
        seed=100,
        start_from=None,  # checkpoint directory to resume from
        id="",
        max_epochs=-1,
        grad_clip=1.0,  # elementwise clamp of every gradient
        drop_prob_lm=0.0,
        drop_prob_reason=0.0,
        drop_prob_fusion=0.0,
        optim="adam",  # adam | sgd (rmsprop, adagrad, adadelta: not ported)
        optim_lr=5e-4,
        learning_rate_decay_start=1,
        learning_rate_decay_every=3,
        learning_rate_decay_rate=0.8,
        optim_adam_beta1=0.9,
        optim_adam_beta2=0.999,
        optim_epsilon=1e-8,
        optim_weight_decay=0.00001,
        optim_momentum=0.0,
        scheduled_sampling_start=-1,
        scheduled_sampling_increase_every=5,
        scheduled_sampling_increase_prob=0.05,
        scheduled_sampling_max_prob=0.25,
        use_label_smoothing=0,
        label_smoothing_epsilon=0.1,
        reason_weight=1.0,
        dtype="float32",  # compute dtype: float32 | bfloat16 (mixed precision)
        use_remat=0,
        remat_policy="save_ctx",
        save_checkpoint_every=5000,
        losses_log_every=25,
        xe_overlap=1,  # dispatch step k+1 before reading loss k
        # SCST (train_rl)
        optim_rl_lr=5e-5,
        optim_rl_lr_ratio=2.0,
        load_lr=0,  # RL lr base = min(XE lr history) / optim_rl_lr_ratio
        use_ppo=0,
        ppo_clip=0.2,
        ppo_k=10,
        entropy_reg=0.01,
        use_baseline=1,  # subtract the greedy rollout's reward
        cider_weight=1.0,
        bleu4_weight=0.0,
        spice_weight=0.0,  # SPICE rewards: not ported (train_rl raises)
        rl_resume=0,  # with start_from: resume from the rl_ checkpoint triple
        rl_overlap=1,  # dispatch rollout k+1 before reading loss k
        load_best_score=1,
        num_eval_no_improve=10,
        # set at run time (by the loader and the schedules)
        vocab_size=None,
        seq_length=None,
        current_lr=None,
        ss_prob=0.0,
    )


CHOICES = {"serve_dtype": ("bfloat16", "float32")}

# flags the CLI keeps even when the checkpoint's saved opt has them
# (eval.py CLI_WINS, as far as serving reads them)
CLI_WINS = {"beam_size", "model_path", "load_model_id", "rl_prefix", "rank",
            "host", "port", "serve_batch_size", "serve_depth", "drain_timeout",
            "serve_dtype", "device", "checkpoint_path"}


class Options(SimpleNamespace):
    """Mutable option namespace with the JAX package's attribute names."""

    def __init__(self, **overrides):
        super().__init__(**_defaults(), **_train_defaults())
        for k, v in overrides.items():
            setattr(self, k, v)


def parse_opt(argv: Optional[Sequence[str]] = None) -> Options:
    parser = argparse.ArgumentParser(description="RFNet caption serving (PyTorch)")
    for key, value in _defaults().items():
        parser.add_argument(f"--{key}", type=type(value), default=value,
                            choices=CHOICES.get(key))
    return Options(**vars(parser.parse_args(argv)))


def merge_checkpoint_opt(opt, saved: dict):
    """Adopt a checkpoint's saved opt (eval.py::merge_checkpoint_opt)."""
    for k, v in saved.items():
        if k in CLI_WINS or k in ("vocab_size", "seq_length", "start_from",
                                  "current_lr"):
            continue
        setattr(opt, k, v)
    # checkpoints from before these flags existed hold the reference
    # (untied) architecture and no value projection
    if "tied_att_keys" not in saved:
        opt.tied_att_keys = 0
    if "low_rank_ctx" not in saved:
        opt.low_rank_ctx = 0
    return opt
