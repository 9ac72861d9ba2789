"""The port's full-pipeline quality proxy against the root pipeline_proxy.py,
on the CPU: the learnable corpus (caption tokens and the features of every
variant), ``test_cider`` on the same parameters (greedy tokens identical,
CIDEr within 1e-9), ``paired_bootstrap_delta`` bit for bit, both ``main``s
over the same stand-ins for the fleets, ``test_cider``, ``load_checkpoint``
and ``eval_ensemble`` (their JSONs equal key for key but ``wall_seconds``
and ``card``), and one real ``--quick --device cpu`` run of the port's
``main`` (one seed: the two-seed run takes about 57 s on one thread, which
chip_smoke.py's phase 17 runs on the card).

The root script is imported with ``JAX_NO_COMPILE_CACHE=1``, so that its
import-time ``enable_compile_cache()`` does nothing.
"""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch import pipeline_proxy as t_proxy
from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.data.dataset import FLIP_TYPE_TO_VARIANT
from recurrent_fusion_network_torch.models import setup as t_setup
from recurrent_fusion_network_torch.training.checkpoint import load_checkpoint

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN, N_VAL, N_TEST, BATCH = 60, 16, 16, 8  # the scripts' --quick corpus


@pytest.fixture(scope="module")
def j_proxy():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("JAX_NO_COMPILE_CACHE", "1")
        spec = importlib.util.spec_from_file_location(
            "root_pipeline_proxy", os.path.join(REPO, "pipeline_proxy.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return module


def _corpora(j_proxy, tmp):
    kw = dict(work_dir=str(tmp), batch_size=BATCH)
    jopt, jl = j_proxy.build_corpus(1, N_TRAIN, N_VAL, N_TEST, **kw)
    topt, tl = t_proxy.build_corpus(1, N_TRAIN, N_VAL, N_TEST, device="cpu", **kw)
    return jopt, jl, topt, tl


def _assert_batches_equal(jb, tb):
    np.testing.assert_array_equal(tb["labels"], jb["labels"])
    assert [i["id"] for i in tb["infos"]] == [i["id"] for i in jb["infos"]]
    for key in ("fc_feats_array", "att_feats_array"):
        assert len(tb[key]) == len(jb[key]) == 3
        for t, j in zip(tb[key], jb[key]):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=1e-6)


def test_build_corpus_equals_the_root_scripts(j_proxy, tmp_path):
    """The same caption tokens; three train batches (random variants) and
    one train batch in each of the 10 variants within 1e-6."""
    jopt, jl, topt, tl = _corpora(j_proxy, tmp_path)
    np.testing.assert_array_equal(tl.dataset.labels, jl.dataset.labels)
    assert tl.split_image_id == jl.split_image_id
    assert (topt.vocab_size, topt.seq_length) == (jopt.vocab_size, jopt.seq_length) == (120, 10)
    for _ in range(3):
        _assert_batches_equal(jl.get_batch("train"), tl.get_batch("train"))
    assert len(FLIP_TYPE_TO_VARIANT) == 10
    for v in FLIP_TYPE_TO_VARIANT:
        _assert_batches_equal(jl.get_batch("train", variant=v), tl.get_batch("train", variant=v))


def test_paired_bootstrap_delta_is_the_root_scripts(j_proxy):
    g = np.random.default_rng(3)
    xe = {1000 + i: float(g.random()) for i in range(150)}
    rl = {1000 + i: float(g.random()) for i in range(2, 152)}
    for seed in (0, 1):
        assert t_proxy.paired_bootstrap_delta(xe, rl, seed=seed) == \
            j_proxy.paired_bootstrap_delta(xe, rl, seed=seed)


# ------------------------------------------------------------ the real run


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    """One real --quick --device cpu run of the port's main, one seed."""
    tmp = tmp_path_factory.mktemp("quick")
    out = tmp / "proxy.json"
    t_proxy.main(["--quick", "--device", "cpu", "--seeds", "1",
                  "--work_dir", str(tmp / "work"), "--out", str(out)])
    with open(out) as f:
        return tmp / "work", json.load(f)


def test_test_cider_equals_the_root_scripts(j_proxy, quick_run, tmp_path, monkeypatch):
    """The quick run's XE best triple, decoded greedily on the test split by
    both scripts' test_cider: the same captions, CIDEr within 1e-9."""
    from recurrent_fusion_network_tpu.models import setup as j_setup

    work, _ = quick_run
    params, _ = load_checkpoint(str(work), "proxy", 0, best=True)
    jopt, jl, topt, tl = _corpora(j_proxy, tmp_path)
    preds = {}

    def recording(module, name):
        real = module.eval_split

        def run(*a, **kw):
            out = real(*a, **kw)
            preds[name] = out[1]
            return out

        monkeypatch.setattr(module, "eval_split", run)

    recording(j_proxy, "jax")
    recording(t_proxy, "port")
    j_cider, j_img = j_proxy.test_cider(j_setup(jopt), params, jl, jopt)
    t_cider, t_img = t_proxy.test_cider(t_setup(topt), params_from_jax(params), tl, topt)
    assert preds["port"] == preds["jax"] and len(preds["port"]) == N_TEST
    assert len({p["caption"] for p in preds["port"]}) > 1
    assert sorted(t_img) == sorted(j_img)
    np.testing.assert_allclose(t_cider, j_cider, rtol=0, atol=1e-9)
    np.testing.assert_allclose([t_img[k] for k in sorted(j_img)],
                               [j_img[k] for k in sorted(j_img)], rtol=0, atol=1e-9)
    assert t_cider > 0


# ------------------------------------------------------------ orchestration


S = 3  # seeds of the stand-in fleets


def _stand_ins(tree, stack):
    """The fleets, test_cider, load_checkpoint and eval_ensemble of one
    package replaced by fixed per-seed values. ``tree(values)`` makes one
    seed's params tree, ``stack(trees)`` the JAX fleet's stacked params (or
    the port's list)."""
    g = np.random.default_rng(11)
    ids = [2000 + i for i in range(N_TEST)]
    per_image = {phase: [{i: float(v) for i, v in zip(ids, g.random(N_TEST))}
                         for _ in range(S)] for phase in ("xe", "rl")}
    # seed 1's RL decode scores as its XE one: ge but not gt
    per_image["rl"][1] = dict(per_image["xe"][1])
    rewards = [dict(enumerate(g.normal(0.1 * r, 1.0, 40))) for r in range(S)]
    calls = []

    def xe_fleet(opt, loader, n_seeds, **kw):
        assert n_seeds == S
        return {"model": None, "cider_per_seed": [0.5, None, 0.7],
                "best_params": [tree([1.0, -2.0, r]) for r in range(S)]}

    def rl_fleet(opt, loader, scorer, n_seeds, **kw):
        # --quick's SCST iterations themselves: both fleets count a warm
        # start's iterations from 0
        assert kw["max_iterations"] == 40
        return {"params": stack([tree([1.0, -2.0, 0.5]) for _ in range(S)]),
                "best_params": [tree([0.0, 0.0, r]) for r in range(S)],
                "cider_per_seed": [0.6, 0.4, 0.7],
                "reward_histories": [{k * 25: v for k, v in h.items()} for h in rewards]}

    def test_cider(model, params, loader, opt, rank=0):
        phase = "xe" if len(calls) < S else "rl"
        calls.append((phase, rank))
        img = per_image[phase][rank]
        return float(np.mean(list(img.values()))), dict(img)

    def eval_ensemble(members, loader, opt, **kw):
        assert len(members) == S and kw["beam_size"] == 1
        return None, {"CIDEr": 0.61}

    return xe_fleet, rl_fleet, test_cider, eval_ensemble


@pytest.fixture(scope="module")
def jax_result(j_proxy, tmp_path_factory):
    """The root script's main over the stand-ins: its JSON."""
    import recurrent_fusion_network_tpu.training.eval_ensemble as j_ens

    tmp = tmp_path_factory.mktemp("jax_main")
    xe, rl, cider, ens = _stand_ins(lambda v: {"w": np.asarray(v, np.float32)},
                                    lambda ts: {"w": np.stack([t["w"] for t in ts])})
    with pytest.MonkeyPatch.context() as m:
        m.setattr(j_proxy, "train_multi_seed", xe)
        m.setattr(j_proxy, "train_multi_seed_rl", rl)
        m.setattr(j_proxy, "test_cider", cider)
        m.setattr(j_proxy, "load_checkpoint",
                  lambda *a, **kw: ({"w": np.zeros(3, np.float32)}, None, {}))
        m.setattr(j_ens, "eval_ensemble", ens)
        m.setattr(sys, "argv", ["pipeline_proxy.py", "--quick", "--seeds", str(S),
                                "--work_dir", str(tmp), "--out", str(tmp / "jax.json")])
        j_proxy.main()
    with open(tmp / "jax.json") as f:
        return json.load(f)


def test_main_equals_the_root_scripts_over_the_same_stand_ins(jax_result, tmp_path,
                                                              monkeypatch):
    xe, rl, cider, ens = _stand_ins(lambda v: {"w": torch.tensor(v, dtype=torch.float32)},
                                    list)
    monkeypatch.setattr(t_proxy, "train_multi_seed", xe)
    monkeypatch.setattr(t_proxy, "train_multi_seed_rl", rl)
    monkeypatch.setattr(t_proxy, "test_cider", cider)
    monkeypatch.setattr(t_proxy, "load_checkpoint",
                        lambda *a, **kw: ({"w": np.zeros(3, np.float32)}, {}))
    monkeypatch.setattr(t_proxy, "eval_ensemble", ens)
    out = tmp_path / "port.json"
    t_proxy.main(["--quick", "--seeds", str(S), "--device", "cpu",
                  "--work_dir", str(tmp_path), "--out", str(out)])
    with open(out) as f:
        port = json.load(f)
    assert port.pop("card") == "cpu"
    assert set(port) == set(jax_result)
    for key in sorted(jax_result):
        if key != "wall_seconds":
            assert port[key] == jax_result[key], key
    # the stand-ins reach both sides of the gates
    assert jax_result["rl_params_changed"] and not jax_result["rl_gt_xe_majority"]
    assert jax_result["rl_ge_xe_raw_per_seed"][1] and not jax_result["rl_gt_xe_per_seed"][1]


def test_a_quick_run_writes_every_key_of_the_root_scripts(quick_run, jax_result):
    work, result = quick_run
    assert set(jax_result) <= set(result) and result["card"] == "cpu"
    assert result["rl_params_changed"] and result["quick"] and result["n_seeds"] == 1
    values = result["xe_test_cider"] + result["rl_test_cider"] + [result["ensemble_test_cider"]]
    assert all(np.isfinite(v) for v in values)
    assert {"rl_model_proxy_0-best.pkl", "model_proxy_0-best.pkl"} <= set(os.listdir(work))
