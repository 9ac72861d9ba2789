"""COCOEvalCap-style evaluation harness.

The port's copy of ``recurrent_fusion_network_tpu/metrics/coco_eval.py``,
replacing the reference's coco-caption pipeline (eval_utils.py:21-62 +
pycocoevalcap/eval.py:18-62): tokenize gts and results, run every scorer
(BLEU-1..4, ROUGE-L, CIDEr-D, the Java-free METEOR and the approximate
SPICE), return the metric dict, and persist the per-image breakdown JSON
under eval_results/.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Optional

from .bleu import compute_bleu
from .cider import compute_cider
from .rouge import compute_rouge
from .tokenizer import tokenize


def evaluate_captions(
    gts: Dict,
    res: Dict,
    *,
    already_tokenized: bool = False,
    extra_scorers: Optional[Dict[str, Callable]] = None,
    meteor_synonyms=None,  # SynonymTable | path | None (env fallback)
    meteor_paraphrases=None,  # ParaphraseTable | path | None (env fallback)
    spice="approx",  # "approx" | None | scorer with .compute_score
) -> Dict[str, object]:
    """gts: {image_id: [sentence, ...]}, res: {image_id: [sentence]}.

    Returns {"overall": {...}, "img_scores": {image_id: {...}}} with keys
    Bleu_1..4, ROUGE_L, CIDEr (CIDEr-D variant), METEOR, SPICE + any extra
    scorers. SPICE defaults to the in-repo APPROXIMATE scorer
    (metrics/spice_approx.py — rule-based scene graphs, not the jar's
    CoreNLP pipeline); pass any scorer with ``compute_score`` instead, or
    spice=None to omit the column.
    """
    assert set(res.keys()) <= set(gts.keys()), "results for unknown image ids"
    gts = {k: gts[k] for k in res.keys()}
    if not already_tokenized:
        gts = tokenize(gts)
        res = tokenize(res)

    keys = sorted(res.keys(), key=str)
    overall: Dict[str, float] = {}
    img_scores: Dict[object, Dict[str, float]] = {k: {} for k in keys}

    bleu_corpus, bleu_sent = compute_bleu(gts, res)
    for n in range(4):
        overall[f"Bleu_{n+1}"] = bleu_corpus[n]
        for k, s in zip(keys, bleu_sent[n]):
            img_scores[k][f"Bleu_{n+1}"] = s

    rouge_mean, rouge_sent = compute_rouge(gts, res)
    overall["ROUGE_L"] = rouge_mean
    for k, s in zip(keys, rouge_sent):
        img_scores[k]["ROUGE_L"] = s

    cider_mean, cider_sent = compute_cider(gts, res)
    overall["CIDEr"] = cider_mean
    for k, s in zip(keys, cider_sent):
        img_scores[k]["CIDEr"] = float(s)

    # Java-free METEOR: exact+stem stages, plus the synonym/paraphrase
    # stages when their data files are supplied (see metrics/meteor.py)
    from .meteor import compute_meteor

    meteor_mean, meteor_sent = compute_meteor(
        gts, res, meteor_synonyms, meteor_paraphrases
    )
    overall["METEOR"] = meteor_mean
    for k, s in zip(keys, meteor_sent):
        img_scores[k]["METEOR"] = s

    if spice is not None and "SPICE" not in (extra_scorers or {}):
        if spice == "approx":
            from .spice_approx import SpiceApprox

            spice = SpiceApprox()
        spice_mean, spice_sent = spice.compute_score(gts, res)
        overall["SPICE"] = spice_mean
        for k, s in zip(keys, spice_sent):
            img_scores[k]["SPICE"] = s

    for name, fn in (extra_scorers or {}).items():
        mean, sent = fn(gts, res)
        overall[name] = mean
        for k, s in zip(keys, sent):
            img_scores[k][name] = s

    return {"overall": overall, "img_scores": img_scores}


def language_eval(
    gts_lookup: Callable[[object], List[str]],
    preds: List[Dict],
    model_id: str,
    split: str,
    *,
    out_dir: str = "eval_results",
    extra_scorers=None,
) -> Dict[str, float]:
    """eval_utils.language_eval equivalent (eval_utils.py:21-62).

    gts_lookup: image_id -> list of reference sentences (strings); predictions
    missing references are filtered out like the reference's COCO-ids filter.
    Writes `{out_dir}/{model_id}_{rand}_{split}.json` with overall + per-image
    scores and returns the overall dict.
    """
    res, gts = {}, {}
    kept = []
    for p in preds:
        refs = gts_lookup(p["image_id"])
        if refs:
            res[p["image_id"]] = [p["caption"]]
            gts[p["image_id"]] = list(refs)
            kept.append(p)
    print(f"using {len(kept)}/{len(preds)} predictions")
    result = evaluate_captions(gts, res, extra_scorers=extra_scorers)

    os.makedirs(out_dir, exist_ok=True)
    tag = f"{model_id}_{random.randint(0, 100000)}_{split}.json"
    img_to_eval = {
        str(k): dict(v, caption=res[k][0]) for k, v in result["img_scores"].items()
    }

    def _finite(obj):
        # SPICE emits NaN for undefined pairs (the jar's convention); bare
        # NaN literals are invalid JSON — serialize them as null
        if isinstance(obj, dict):
            return {k: _finite(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [_finite(v) for v in obj]
        if isinstance(obj, float) and obj != obj:
            return None
        return obj

    with open(os.path.join(out_dir, tag), "w") as f:
        json.dump(_finite({"overall": result["overall"],
                           "imgToEval": img_to_eval}), f)
    return result["overall"]
