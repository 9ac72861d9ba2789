"""Pieces the kinds' drivers share: the port's options for a cell, the
port's dataset over the benchmark's corpus, and the image of a tree."""

from __future__ import annotations

from portbench.harness.env import sub_seed


def port_seed(seed: int) -> int:
    """The seed handed to the port (its loader's and its generator's)."""
    return sub_seed(seed, "port") % (2 ** 31)


def options(job, **extra):
    """The port's Options for the cell: the configuration's widths, the
    traffic's settings, the run's device and seed."""
    from recurrent_fusion_network_torch.config import Options

    cfg = job.config
    feats = [{"fc_feat_size": e["fc_feat_size"], "att_feat_size": e["att_feat_size"],
              "att_num": e["att_num"]} for e in cfg["encoders"]]
    kw = dict(caption_model=cfg["model"], feature_type="feat_array", feat_array_info=feats,
              rnn_size=cfg["rnn_size"], input_encoding_size=cfg["input_encoding_size"],
              att_hid_size=cfg["att_hid_size"], num_review_steps=cfg["num_review_steps"],
              top_words_count=cfg["top_words_count"], tied_att_keys=cfg["tied_att_keys"],
              device=job.device, seed=port_seed(job.seed), language_eval=0,
              vocab_size=cfg["vocab_size"], seq_length=cfg["seq_length"])
    if "num_review_steps_0" in cfg:
        kw["num_review_steps_0"] = cfg["num_review_steps_0"]
    if "use_mos" in cfg:
        kw["use_mos"] = cfg["use_mos"]
    kw.update(extra)
    return Options(**kw)


def port_dataset(corpus):
    """The port's Dataset over the corpus: every image in the train split,
    its captions as consecutive label rows."""
    from recurrent_fusion_network_torch.data.dataset import Dataset

    n, caps, L = corpus.labels.shape
    info = {"ix_to_word": corpus.words(),
            "images": [{"id": int(i), "split": "train", "file_path": ""}
                       for i in corpus.image_ids]}
    starts = [1 + caps * i for i in range(n)]
    ends = [caps * (i + 1) for i in range(n)]
    return Dataset(info, corpus.labels.reshape(n * caps, L), starts, ends,
                   corpus.top_words())


def model_layout(opt, device=None):
    """(the port's model, its parameter tree as meta tensors: names and
    shapes). The tree is drawn once by the model's own initializer on
    ``device`` (the run's; that takes a fraction of a second where the
    meta device's first use takes seconds) and only its shapes are kept."""
    import torch

    from recurrent_fusion_network_torch.models import setup

    from portbench.harness.trees import leaves, rebuild

    model = setup(opt)
    device = device or opt.device
    if device == "meta":
        return model, model.init_params(None, device="meta")
    drawn = model.init_params(torch.Generator(device=device).manual_seed(0), device=device)
    return model, rebuild(drawn, [torch.empty(x.shape, device="meta") for x in leaves(drawn)])
