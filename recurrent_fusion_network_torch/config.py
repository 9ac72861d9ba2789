"""Options of the port's entry points.

The port's own copy of ``recurrent_fusion_network_tpu/config.py`` and of
``eval.py``'s ``CLI_WINS`` / ``merge_checkpoint_opt``: the flag names and
defaults of the model, training, data, eval, checkpoint, logging and
preemption options, the feature wiring from the encoder registry, the
post-parse checks, and the checkpoint merge (the CLI wins for runtime knobs,
the checkpoint's saved opt for the architecture). ``parse_opt`` parses the
training and eval CLIs (``main``, ``main_rl``, ``eval``); the serve CLI keeps
its own, smaller parser (``parse_serve_opt``).

``dp_devices`` maps --num_dp_devices, --num_mp_devices and --async_opt to
the training CLIs' ranks (dp x mp of them).
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Optional, Sequence

from . import feat_registry


def _defaults() -> dict:
    return dict(
        # model options (the JAX package's defaults; a checkpoint's saved
        # opt overrides them)
        caption_model="show_tell",
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
        # serving; the training and eval CLIs' --ip / --port are the SPICE
        # reward service's (--spice_backend http, metrics/spice.py;
        # metrics/spice_server.py is one), the serve CLI's --port the HTTP
        # front end's (8080, parse_serve_opt)
        host="0.0.0.0",
        port=8090,
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
        optim="adam",  # adam | sgd | rmsprop | adagrad | adadelta
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
        spice_weight=0.0,  # SPICE reward weight (--spice_backend approx | http)
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


def _driver_defaults() -> dict:
    """Data, eval, checkpoint, logging and preemption options of the
    training and eval CLIs, the JAX package's flag names and defaults (its
    flags without a port counterpart are kept, so a checkpoint's saved opt
    and a JAX command line read the same)."""
    return dict(
        # data input
        input_json="data/cocotalk.json",
        input_label_h5="data/cocotalk_label.h5",
        top_words_path="data/vocab_train.pkl",
        feature_type="inception_v3",
        official_train_id_file="data/official_split/official_train_id.txt",
        official_val_id_file="data/official_split/official_val_id.txt",
        official_test_id_file="data/official_split/official_test_id.txt",
        use_official_split=0,
        use_flip=0,
        use_crop=0,
        aug_type=0,
        use_mos=0,
        num_expert=10,
        num_layers=1,
        rnn_type="lstm",
        max_iterations=-1,  # hard iteration cap (-1 = off)
        batch_size=10,
        drop_prob_obj_att=0.0,
        drop_prob_connect=0.0,
        seq_per_img=5,
        optim_rmsprop_alpha=0.99,
        optim_lr_decay=0.0,
        optim_rho=0.9,
        # evaluation
        val_images_use=5000,
        language_eval=1,
        train_only=0,
        verbose=0,
        online_training=0,
        use_cuda=0,
        async_opt=0,
        num_processes=4,
        # 'approx': the approximate scorer in-process; 'http': a spiceD-protocol
        # service at --ip/--port (metrics/spice.py::make_spice_fn)
        spice_backend="approx",
        num_head=8,
        drop_prob_self_attn=0.1,
        guiding_weight=1.0,
        guiding_l1_penality=0.001,
        review_net_same_rnn=0,
        eval_split="test",
        eval_flip_ensemble=0,
        image_folder="",
        image_root="",
        infos_path="",
        sample_max=1,
        print_beam_candidate=0,
        print_top_words=0,
        eval_ensemble_multi_gpu=0,
        eval_num_models_per_gpu=4,
        ip="localhost",
        synthetic_features=0,
        backbone_weights="",
        backbone_arch="resnet101",
        json_log="",  # JSONL event log path (utils/logging.py)
        eval_results_dir="eval_results",  # per-image metric JSONs of eval_split
        data_root="data/features",
        num_dp_devices=1,
        # the 'mp' axis of solo XE training: the vocabulary-wide logit and
        # embedding split over mp ranks of a dp x mp mesh (parallel/mesh.py
        # shard_params_2d); optional at 512-dim scale, >1 builds the mesh
        num_mp_devices=1,
        n_seeds=1,
        checkpoint_backend="pickle",  # 'pickle' (the reference's triple files) |
        # 'orbax' (torch.distributed.checkpoint directories, training/orbax_ckpt.py)
        checkpoint_async=0,  # orbax only: the write runs in the background
        graceful_preempt=1,  # SIGTERM -> checkpoint at the next boundary
        profile_dir="",  # a torch.profiler Chrome trace of the window goes here
        profile_start=5,  # first iteration of the trace window
        profile_steps=0,  # iterations traced (0 = off)
    )


def _serve_defaults() -> dict:
    """The serve CLI's own flags beside ``parse_opt``'s (the JAX serve
    CLI's pre-parser, ``serve.py:24-53``): --port is the HTTP front end's;
    --serve_dp_devices N splits each decode batch over a mesh of the first
    N cards (--serve_batch_size must divide by N)."""
    return dict(port=8080, serve_frontend="asyncio", serve_dp_devices=1)


CHOICES = {"serve_dtype": ("bfloat16", "float32"), "dtype": ("float32", "bfloat16"),
           "serve_frontend": ("asyncio", "threads")}
# run-time keys without a flag (ss_prob has one, as in the JAX package)
_RUNTIME = ("vocab_size", "seq_length", "current_lr")

# the port's own options, which the JAX package's do not have: a
# checkpoint's saved opt leaves them out, as the JAX eval adopts every
# saved key it does not override (``is_jax_key``)
PORT_ONLY = frozenset({"device", "host", "rank", "rl_prefix", "serve_batch_size",
                       "serve_depth", "drain_timeout", "serve_dtype", "eval_results_dir"})
# keys the feature wiring adds to the options of both packages
_WIRED = frozenset({"feat_array_info", "fc_feat_size", "att_feat_size", "att_num"})

# flags the eval CLI (and the serve CLI) keep even when the checkpoint's
# saved opt has them (JAX eval.py CLI_WINS, plus the port's device and the
# serving flags)
CLI_WINS = {
    "beam_size", "eval_split", "val_images_use", "language_eval", "sample_max",
    "batch_size", "seq_per_img", "input_json", "input_label_h5",
    "top_words_path", "data_root", "synthetic_features", "verbose", "id",
    "model_path", "infos_path", "load_model_id", "eval_flip_ensemble",
    "print_beam_candidate", "print_top_words", "seed",
    "spice_backend", "ip", "port",
    "dtype", "profile_dir", "profile_steps", "checkpoint_async",
    "image_folder", "image_root", "backbone_weights", "backbone_arch",
    "device", "rl_prefix", "rank", "host", "serve_batch_size", "serve_depth",
    "drain_timeout", "serve_dtype", "eval_results_dir",
}


_JAX_KEYS = frozenset({**_defaults(), **_train_defaults(), **_driver_defaults()}) - PORT_ONLY


class Options(SimpleNamespace):
    """Mutable option namespace with the JAX package's attribute names."""

    def __init__(self, **overrides):
        super().__init__(**_defaults(), **_train_defaults(), **_driver_defaults())
        for k, v in overrides.items():
            setattr(self, k, v)


def _add_flags(parser, defaults: dict) -> None:
    for key, value in defaults.items():
        if key in _RUNTIME:
            continue
        kind = str if value is None else type(value)
        parser.add_argument(f"--{key}", type=kind, default=value, choices=CHOICES.get(key))


def is_jax_key(key: str) -> bool:
    """Whether the JAX package's options have ``key``: its flags, its
    run-time keys, and the keys and ``input_*_dir`` paths of the feature
    wiring."""
    if key in PORT_ONLY:
        return False
    return (key in _JAX_KEYS or key in _WIRED
            or (key.startswith(("input_fc", "input_att")) and key.endswith("_dir")))


def parse_serve_opt(argv: Optional[Sequence[str]] = None) -> Options:
    """The serve CLI's flags: every ``parse_opt`` flag and the front end's
    (--serve_frontend asyncio | threads, --serve_dp_devices; --port is the
    HTTP front end's), as the JAX serve CLI reads them."""
    parser = argparse.ArgumentParser(description="RFNet caption serving (PyTorch)")
    _add_flags(parser, {**_defaults(), **_train_defaults(), **_driver_defaults(),
                        **_serve_defaults()})
    opt = Options(**vars(parser.parse_args(argv)))
    finalize_options(opt)
    return opt


def parse_opt(argv: Optional[Sequence[str]] = None) -> Options:
    """The training and eval CLIs' flags (JAX config.parse_opt)."""
    parser = argparse.ArgumentParser(description="RFNet captioning options (PyTorch)")
    _add_flags(parser, {**_defaults(), **_train_defaults(), **_driver_defaults()})
    opt = Options(**vars(parser.parse_args(argv)))
    finalize_options(opt)
    return opt


def validate_options(opt) -> None:
    """Post-parse checks (the reference's opts.py)."""
    assert opt.rnn_size > 0, "rnn_size should be greater than 0"
    assert opt.num_layers > 0, "num_layers should be greater than 0"
    assert opt.input_encoding_size > 0, "input_encoding_size should be greater than 0"
    assert opt.batch_size > 0, "batch_size should be greater than 0"
    assert 0 <= opt.drop_prob_lm <= 1, "drop_prob_lm should be between 0 and 1"
    assert opt.seq_per_img > 0, "seq_per_img should be greater than 0"
    assert opt.beam_size > 0, "beam_size should be greater than 0"
    assert opt.save_checkpoint_every > 0, "save_checkpoint_every should be greater than 0"
    assert opt.losses_log_every > 0, "losses_log_every should be greater than 0"
    assert opt.language_eval in (0, 1), "language_eval should be 0 or 1"
    assert opt.remat_policy in ("save_ctx", "full"), \
        "remat_policy should be 'save_ctx' or 'full'"
    assert opt.load_best_score in (0, 1), "load_best_score should be 0 or 1"
    assert opt.train_only in (0, 1), "train_only should be 0 or 1"


def dp_devices(opt) -> int:
    """The ranks the training CLIs run (JAX main.py:38-57): --num_dp_devices
    x --num_mp_devices, the dp count recorded in ``opt.num_dp_devices``.
    --async_opt 1 (the reference's Hogwild processes) with --num_dp_devices
    <= 1 maps to synchronous data parallelism over min(--num_processes, the
    visible cards) on CUDA and over --num_processes gloo ranks on the CPU.
    On CUDA more ranks than visible cards raise, as the JAX package's
    make_mesh / make_mesh_2d assert. The eval, ensemble and serve CLIs read
    none of these flags, as in the JAX package."""
    import torch

    cuda = opt.device != "cpu"
    cards = torch.cuda.device_count() if cuda else None
    if opt.async_opt and opt.num_dp_devices <= 1:
        opt.num_dp_devices = min(opt.num_processes, cards) if cuda else opt.num_processes
        print(f"--async_opt 1 -> synchronous DP over {opt.num_dp_devices} device(s)")
    if opt.num_dp_devices < 1:
        raise ValueError(f"--num_dp_devices {opt.num_dp_devices} should be at least 1")
    if opt.num_mp_devices < 1:
        raise ValueError(f"--num_mp_devices {opt.num_mp_devices} should be at least 1")
    world = opt.num_dp_devices * opt.num_mp_devices
    if cuda and world > cards:
        raise ValueError(f"--num_dp_devices {opt.num_dp_devices} x --num_mp_devices "
                         f"{opt.num_mp_devices}: need {world} CUDA devices, have {cards}")
    return world


def _wire_features(opt) -> None:
    """Feature-path expansion from the registry (JAX config._wire_features)."""
    if getattr(opt, "feat_array_info", None):
        return  # an explicit encoder list (tests / synthetic data)
    if opt.feature_type == "synthetic":
        # files-free smoke runs: small fabricated encoder dims (one encoder,
        # or M = 3 heterogeneous ones for the fusion model)
        if opt.caption_model == "recurrent_fusion_model":
            opt.feat_array_info = [
                {"fc_feat_size": 64, "att_feat_size": 48, "att_num": 8},
                {"fc_feat_size": 48, "att_feat_size": 32, "att_num": 6},
                {"fc_feat_size": 56, "att_feat_size": 40, "att_num": 7},
            ]
        else:
            opt.feat_array_info = [{"fc_feat_size": 64, "att_feat_size": 48, "att_num": 8}]
        return
    if opt.feature_type == "feat_array":
        opt.feat_array_info = feat_registry.feat_array_info(opt.data_root)
        return
    info = feat_registry.encoder_info(opt.feature_type, opt.data_root)
    opt.feat_array_info = [info]
    opt.input_fc_dir = info["original"]["fc"]
    opt.input_att_dir = info["original"]["att"]
    for variant in feat_registry.VARIANTS:
        dirs = info.variant_dirs(variant)
        suffix = "" if variant == "original" else "_" + variant
        ref_suffix = suffix.replace("_crop_tr", "_crop")  # the reference's flag names
        setattr(opt, f"input_fc{ref_suffix}_dir", dirs["fc"])
        setattr(opt, f"input_att{ref_suffix}_dir", dirs["att"])
    opt.fc_feat_size = info.fc_feat_size
    opt.att_feat_size = info.att_feat_size
    opt.att_num = info.att_num


def finalize_options(opt) -> None:
    validate_options(opt)
    _wire_features(opt)
    if not hasattr(opt, "feat_array_info"):
        opt.feat_array_info = []
    if getattr(opt, "tied_att_keys", 0) == -1:  # auto follows the profile
        opt.tied_att_keys = 0 if getattr(opt, "reference_parity", 0) else 1


def merge_checkpoint_opt(opt, saved: dict):
    """Adopt a checkpoint's saved opt (JAX eval.py::merge_checkpoint_opt):
    every key but the CLI's own (``CLI_WINS``) and the run-time ones; the
    features re-wired under the CLI's ``data_root`` when the checkpoint
    holds registry entries, copied when it holds plain dicts."""
    for k, v in saved.items():
        if k in CLI_WINS or k in ("vocab_size", "seq_length", "start_from",
                                  "checkpoint_path", "current_lr", "feat_array_info"):
            continue
        setattr(opt, k, v)
    # checkpoints from before these flags existed hold the reference
    # (untied) architecture and no value projection
    if "tied_att_keys" not in saved:
        opt.tied_att_keys = 0
    if "low_rank_ctx" not in saved:
        opt.low_rank_ctx = 0
    saved_fai = saved.get("feat_array_info")
    if saved_fai and all(isinstance(f, dict) for f in saved_fai):
        opt.feat_array_info = saved_fai
    elif saved_fai:
        opt.feat_array_info = None
        _wire_features(opt)
    return opt
