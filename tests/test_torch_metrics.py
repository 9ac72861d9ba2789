"""The port's caption metrics vs the JAX package's, on the CPU.

Seeded random captions over the synthetic fixture's vocabulary, plus
punctuated COCO-style strings, go through both packages' tokenizer, BLEU,
ROUGE-L, CIDEr-D, METEOR (with and without a synonym table), approximate
SPICE and the evaluate_captions / language_eval harness. Corpus and
per-image scores must agree to 1e-12.
"""

import json
import os

import numpy as np
import pytest

from recurrent_fusion_network_torch.data.synthetic import WORDS
from recurrent_fusion_network_torch.metrics import bleu as t_bleu
from recurrent_fusion_network_torch.metrics import cider as t_cider
from recurrent_fusion_network_torch.metrics import coco_eval as t_coco
from recurrent_fusion_network_torch.metrics import meteor as t_meteor
from recurrent_fusion_network_torch.metrics import rouge as t_rouge
from recurrent_fusion_network_torch.metrics import spice_approx as t_spice
from recurrent_fusion_network_torch.metrics import tokenizer as t_tok
from recurrent_fusion_network_tpu.metrics import bleu as j_bleu
from recurrent_fusion_network_tpu.metrics import cider as j_cider
from recurrent_fusion_network_tpu.metrics import coco_eval as j_coco
from recurrent_fusion_network_tpu.metrics import meteor as j_meteor
from recurrent_fusion_network_tpu.metrics import rouge as j_rouge
from recurrent_fusion_network_tpu.metrics import spice_approx as j_spice
from recurrent_fusion_network_tpu.metrics import tokenizer as j_tok

TOL = 1e-12
COCO = [
    "A man riding a wave on top of a surfboard.",
    "Two dogs, playing in the park -- near a red ball!",
    "The cat's sitting on (a) chair; it doesn't move...",
    "A woman holding an umbrella in the rain?",
    "three small birds sitting on a tree branch",
    "A plate of food with broccoli and carrots: delicious",
]


def _captions(seed=0, n=12, refs=5):
    """{image_id: [refs]} and {image_id: [hypothesis]}: random word
    sequences of the synthetic vocabulary, every third image a COCO-style
    string with punctuation."""
    g = np.random.default_rng(seed)

    def sent():
        if g.random() < 0.3:
            return COCO[int(g.integers(len(COCO)))]
        return " ".join(g.choice(WORDS, int(g.integers(3, 11))))

    gts = {100 + i: [sent() for _ in range(refs)] for i in range(n)}
    res = {100 + i: [gts[100 + i][0] if i % 4 == 0 else sent()] for i in range(n)}
    return gts, res


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=TOL,
                               atol=TOL)


def test_tokenize_matches_jax():
    gts, res = _captions(1)
    assert t_tok.tokenize(gts) == j_tok.tokenize(gts)
    assert t_tok.tokenize(res) == j_tok.tokenize(res)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bleu_rouge_cider_match_jax(seed):
    gts, res = _captions(seed)
    gts, res = j_tok.tokenize(gts), j_tok.tokenize(res)
    (tc, ts), (jc, js) = t_bleu.compute_bleu(gts, res), j_bleu.compute_bleu(gts, res)
    _close(tc, jc)
    _close(ts, js)
    for t_fn, j_fn in ((t_rouge.compute_rouge, j_rouge.compute_rouge),
                       (t_cider.compute_cider, j_cider.compute_cider)):
        (tm, tsent), (jm, jsent) = t_fn(gts, res), j_fn(gts, res)
        _close(tm, jm)
        _close(tsent, jsent)
    assert max(tc) > 0.1


@pytest.fixture
def synonyms(tmp_path):
    path = tmp_path / "synonyms.txt"
    path.write_text("man guy person\ndog puppy hound\nsitting seated\nred crimson\n")
    return str(path)


@pytest.mark.parametrize("with_synonyms", [False, True])
def test_meteor_matches_jax(synonyms, with_synonyms):
    gts, res = _captions(3)
    res[101] = ["a guy seated on a crimson chair"]
    gts[101] = ["a man sitting on a red chair"] + gts[101][1:]
    gts, res = j_tok.tokenize(gts), j_tok.tokenize(res)
    syn = synonyms if with_synonyms else None
    (tm, ts) = t_meteor.compute_meteor(gts, res, syn, None)
    (jm, js) = j_meteor.compute_meteor(gts, res, syn, None)
    _close(tm, jm)
    _close(ts, js)
    keys = sorted(res, key=str)
    plain = t_meteor.compute_meteor(gts, res, None, None)[1][keys.index(101)]
    assert (ts[keys.index(101)] > plain) == with_synonyms


def test_spice_approx_matches_jax():
    gts, res = _captions(4)
    gts, res = j_tok.tokenize(gts), j_tok.tokenize(res)
    t, j = t_spice.SpiceApprox(), j_spice.SpiceApprox()
    (tm, ts), (jm, js) = t.compute_score(gts, res), j.compute_score(gts, res)
    _close(tm, jm)
    _close(ts, js)
    assert json.dumps(t.last_details, sort_keys=True, default=str) == json.dumps(
        j.last_details, sort_keys=True, default=str)


def test_evaluate_captions_and_language_eval_match_jax(tmp_path):
    gts, res = _captions(5)
    t, j = t_coco.evaluate_captions(gts, res), j_coco.evaluate_captions(gts, res)
    names = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr", "METEOR", "SPICE"]
    assert sorted(t["overall"]) == sorted(j["overall"]) == sorted(names)
    for k in names:
        _close(t["overall"][k], j["overall"][k])
        _close([t["img_scores"][i][k] for i in res], [j["img_scores"][i][k] for i in res])
    preds = [{"image_id": i, "caption": c[0]} for i, c in res.items()]
    preds.append({"image_id": 999, "caption": "an image without references"})
    lookup = lambda i: gts.get(i, [])  # noqa: E731
    ts = t_coco.language_eval(lookup, preds, "m", "val", out_dir=str(tmp_path / "t"))
    js = j_coco.language_eval(lookup, preds, "m", "val", out_dir=str(tmp_path / "j"))
    for k in names:
        _close(ts[k], js[k])
    [written] = os.listdir(tmp_path / "t")
    with open(tmp_path / "t" / written) as f:
        assert len(json.load(f)["imgToEval"]) == len(res)
