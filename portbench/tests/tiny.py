"""Tiny cells for the CPU tests: the flagship's structure (five encoders,
two review stages; ReviewNet's one encoder) at small widths, and the two
traffic kinds at a few rows. Limits for the CPU's f32 arithmetic on both
sides."""

from __future__ import annotations

import copy
import json

from portbench.harness.env import ROOT

ENCODERS = [
    {"name": "e0", "fc_feat_size": 24, "att_num": 7, "att_feat_size": 16},
    {"name": "e1", "fc_feat_size": 16, "att_num": 4, "att_feat_size": 12},
    {"name": "e2", "fc_feat_size": 20, "att_num": 5, "att_feat_size": 8},
]
WIDTHS = {"rnn_size": 16, "input_encoding_size": 16, "att_hid_size": 16,
          "vocab_size": 40, "seq_length": 6, "top_words_count": 12}
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3, "label_rows": 0,
          "lp_gap": 1e-4, "beam_gap": 1e-4, "rollout_gap": 1e-4, "reward_gap": 1e-6}


def config_of(name: str) -> str:
    """The model of configuration ``name``."""
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["model"]


def config(model: str) -> dict:
    name = {"recurrent_fusion_model": "rfnet-flagship",
            "review_net": "reviewnet-inception-v3"}[model]
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg.update(WIDTHS)
    cfg["num_review_steps"] = 3
    if model == "recurrent_fusion_model":
        cfg["encoders"] = copy.deepcopy(ENCODERS)
        cfg["num_review_steps_0"] = 2
    else:
        cfg["encoders"] = copy.deepcopy(ENCODERS[:1])
    return cfg


def traffic(name: str) -> dict:
    tr = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
    if tr["kind"] in ("xe", "scst"):
        tr.update(images_per_step=4, train_images=12, warmup_steps=4, trace_steps=2,
                  reference_block_images=3)
    else:
        tr.update(serve_batch=4, outstanding=12, clients=2, pool_images=16,
                  warmup_batches=2, sample_requests=6, trace_batches=2)
    return tr
