"""The port's multi-seed XE and SCST fleets, on the CPU at tiny widths: seed
r against the port's solo loops (bit for bit, dropout on), the fleets
against the JAX package's (resumed from the same per-seed triples, dropout
0, no scheduled sampling: per-seed losses and params rtol 1e-4 / atol
1e-5), and the fleet's files: -best gating, rolling naming, early stop,
preemption, resume as a fleet and as one seed, the SCST warm start and its
ship-best contract, the CLIs, and the JAX ensemble eval of the port's
triples.

The SCST fleets against the JAX package's run with the rollout's sampled
half forced to the greedy decode (the two frameworks' random streams
differ) and without the baseline, so every reward is the greedy caption's
CIDEr-D.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch import main as t_main
from recurrent_fusion_network_torch import main_rl as t_main_rl
from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.data.prepro_ngrams import compute_doc_freq
from recurrent_fusion_network_torch.data.synthetic import synthetic_setup as t_setup
from recurrent_fusion_network_torch.decoding.api import model_sample as t_model_sample
from recurrent_fusion_network_torch.ops.initializers import tree_leaves
from recurrent_fusion_network_torch.rewards.cider_d import CiderD
from recurrent_fusion_network_torch.training import checkpoint as t_ckpt
from recurrent_fusion_network_torch.training import eval_split as t_eval_split
from recurrent_fusion_network_torch.training import multi_seed as t_ms
from recurrent_fusion_network_torch.training.eval_ensemble import eval_ensemble as t_eval_ens
from recurrent_fusion_network_torch.training.preempt import PreemptGuard
from recurrent_fusion_network_torch.training.train_loop import train as t_train
from recurrent_fusion_network_torch.training.train_rl_loop import train_rl as t_train_rl
from recurrent_fusion_network_tpu.data.synthetic import synthetic_setup as j_setup
from recurrent_fusion_network_tpu.decoding.api import model_sample as j_model_sample
from recurrent_fusion_network_tpu.models import setup as j_model
from recurrent_fusion_network_tpu.training import checkpoint as j_ckpt
from recurrent_fusion_network_tpu.training import multi_seed as j_ms
from recurrent_fusion_network_tpu.training import train_rl_loop as j_rl
from recurrent_fusion_network_tpu.training.eval_ensemble import eval_ensemble as j_eval_ens

from test_torch_drivers import TINY_FLAGS

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5


def quiet(*_):
    pass


def _setups(tmp, **over):
    """(jopt, topt, JAX loader, port loader) of the synthetic fixture: 3
    encoders, width 16, 2 + 2 review steps, 4 images x 2 captions a batch,
    one val batch per eval."""
    kw = dict(batch_size=4, seq_per_img=2, losses_log_every=1, val_images_use=4,
              eval_results_dir=os.path.join(str(tmp), "eval_results"), **over)
    jopt, jl = j_setup(**kw)
    topt, tl = t_setup(**kw, device="cpu")
    return jopt, topt, jl, tl


def _port(tmp, run_id="f", **over):
    _, topt, _, tl = _setups(tmp, **over)
    topt.checkpoint_path, topt.id = str(tmp), run_id
    return topt, tl


def _scorer(loader):
    ids = loader.split_image_id["train"]
    return CiderD(compute_doc_freq(loader.dataset, ids), float(np.log(len(ids))))


def _jax_scorer(loader):
    from recurrent_fusion_network_tpu.data.prepro_ngrams import compute_doc_freq as j_df
    from recurrent_fusion_network_tpu.rewards.cider_d import CiderD as JaxCiderD

    ids = loader.split_image_id["train"]
    return JaxCiderD(j_df(loader.dataset, ids), float(np.log(len(ids))))


def _assert_trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y)


def _trigger_after(monkeypatch, n):
    """PreemptGuard.sync reads True from its n-th call on (SIGTERM)."""
    calls = []

    def sync(self):
        calls.append(1)
        return len(calls) >= n

    monkeypatch.setattr(PreemptGuard, "sync", sync)


def _scores(monkeypatch, by_rank):
    """eval_split scores each rank's evals in turn from ``by_rank``."""
    seen = {}

    def fake(model, params, loader, opt, *, split="val", rank=0, **kw):
        k = seen[rank] = seen.get(rank, -1) + 1
        return 1.0, [], {"CIDEr": by_rank[rank][min(k, len(by_rank[rank]) - 1)]}

    monkeypatch.setattr(t_eval_split, "eval_split", fake)


# ------------------------------------------------------ seed r == solo rank r


def test_xe_fleet_seed_is_the_solo_run_bit_for_bit(tmp_path):
    """Dropout on, a boundary at 2: seed 1's losses, val history and final
    params and moments equal solo train(rank=1)'s; the seeds differ."""
    topt, tl = _port(tmp_path / "fleet", drop_prob_lm=0.3, save_checkpoint_every=2)
    fleet = t_ms.train_multi_seed(topt, tl, 2, max_iterations=3, eval_at_end=False,
                                  log_fn=quiet)
    topt, tl = _port(tmp_path / "solo", drop_prob_lm=0.3, save_checkpoint_every=2)
    solo = t_train(topt, tl, rank=1, max_iterations=3, log_fn=quiet)
    assert fleet["iter"] == solo["iter"] == 3
    assert fleet["loss_histories"][1] == solo["loss_history"]
    assert fleet["loss_histories"][0] != solo["loss_history"]
    assert fleet["val_histories"][1] == solo["val_result_history"]
    _assert_trees_equal(fleet["params"][1], solo["final_params"])
    _assert_trees_equal(fleet["opt_states"][1].nu, solo["final_opt_state"].nu)


def test_scst_fleet_seed_is_the_solo_run_bit_for_bit(tmp_path):
    """From scratch, multinomial rollouts from each seed's generator: seed
    1's rewards, losses and final params equal solo train_rl(rank=1)'s."""
    topt, tl = _port(tmp_path / "fleet", save_checkpoint_every=100)
    fleet = t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=3,
                                     eval_at_end=False, log_fn=quiet)
    topt, tl = _port(tmp_path / "solo", save_checkpoint_every=100)
    solo = t_train_rl(topt, tl, _scorer(tl), rank=1, max_iterations=3, log_fn=quiet)
    assert fleet["loss_histories"][1] == solo["loss_history"]
    assert fleet["train_loss_histories"][1] == solo["train_loss_history"]
    assert fleet["loss_histories"][0] != solo["loss_history"]
    _assert_trees_equal(fleet["params"][1], solo["final_params"])


# ------------------------------------------------------------- vs the JAX fleet


def _jax_triples(tmp, jopt, best, seeds=(7, 8)):
    """JAX-written per-seed params triples at iteration 0, no optimizer."""
    jm = j_model(jopt)
    out = []
    for r, seed in enumerate(seeds):
        p = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
        j_ckpt.save_checkpoint(str(tmp), "zero", r, params=p, best=best,
                               infos={"iter": 0, "epoch": 0, "opt": dict(vars(jopt))})
        out.append(p)
    return out


def _assert_fleet_params_close(jparams, tparams):
    for r, tp in enumerate(tparams):
        jp = jax.tree_util.tree_map(lambda x: np.asarray(x[r]), jparams)
        jl = jax.tree_util.tree_leaves(jp)
        tl = jax.tree_util.tree_leaves(tp)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b.numpy(), a, rtol=RTOL, atol=ATOL)


def test_xe_fleet_matches_the_jax_fleet(tmp_path):
    """Both fleets resumed from the same JAX-written per-seed triples (of
    ShowTell, whose vmapped JAX step compiles in a quarter of RFNet's time;
    the SCST comparison below runs RFNet): three steps' per-seed losses and
    the final per-seed params."""
    jopt, topt, jl, tl = _setups(tmp_path, caption_model="show_tell")
    starts = _jax_triples(tmp_path / "start", jopt, best=False)
    for opt in (jopt, topt):
        opt.start_from, opt.load_model_id = str(tmp_path / "start"), "zero"
    j = j_ms.train_multi_seed(jopt, jl, 2, max_iterations=3, eval_at_end=False, save=False,
                              log_fn=quiet)
    t = t_ms.train_multi_seed(topt, tl, 2, max_iterations=3, eval_at_end=False, save=False,
                              log_fn=quiet)
    for r in range(2):
        assert sorted(t["loss_histories"][r]) == sorted(j["loss_histories"][r]) == [0, 1, 2]
        np.testing.assert_allclose([t["loss_histories"][r][i] for i in range(3)],
                                   [j["loss_histories"][r][i] for i in range(3)], rtol=RTOL)
    _assert_fleet_params_close(j["params"], t["params"])
    assert not np.allclose(starts[0]["embed"], t["params"][0]["embed"].numpy())


def _greedy_rollouts(monkeypatch):
    """Both packages' rollouts with the sampled half forced to the greedy
    decode."""
    def jax_rollout(model, jit=True):
        def rollout(params, fc, att, rng):
            seq = j_model_sample(model, params, fc, att, beam_size=1).seq
            return seq, seq
        return rollout

    def port_rollout(model):
        @torch.no_grad()
        def rollout(params, fc, att, generator):
            seq = t_model_sample(model, params, fc, att, beam_size=1).seq
            return seq, seq
        return rollout

    monkeypatch.setattr(j_rl, "make_rollout_fn", jax_rollout)
    monkeypatch.setattr(t_ms, "make_rollout_fn", port_rollout)


def test_scst_fleet_matches_the_jax_fleet(tmp_path, monkeypatch):
    """Both fleets warm-started from the same JAX-written per-seed XE best
    triples, greedy rollouts, no baseline: three iterations' per-seed mean
    rewards and the final per-seed params."""
    _greedy_rollouts(monkeypatch)
    jopt, topt, jl, tl = _setups(tmp_path, use_baseline=0, optim_rl_lr=1e-3)
    _jax_triples(tmp_path / "start", jopt, best=True)
    for opt in (jopt, topt):
        opt.start_from, opt.load_model_id = str(tmp_path / "start"), "zero"
    j = j_ms.train_multi_seed_rl(jopt, jl, _jax_scorer(jl), 2, max_iterations=3,
                                 eval_at_end=False, save=False, log_fn=quiet)
    t = t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=3,
                                 eval_at_end=False, save=False, log_fn=quiet)
    for r in range(2):
        got, want = t["loss_histories"][r], j["reward_histories"][r]
        assert sorted(got) == sorted(want) == [0, 1, 2]
        np.testing.assert_allclose([got[i] for i in range(3)], [want[i] for i in range(3)],
                                   rtol=RTOL)
        assert any(v > 0 for v in got.values())
    _assert_fleet_params_close(j["params"], t["params"])


# --------------------------------------------------------------- the files


def _infos(tmp, run_id, r, best, prefix=""):
    return t_ckpt.load_checkpoint(str(tmp), run_id, r, best=best, prefix=prefix)[1]


def test_per_seed_best_gating_and_rolling_names(tmp_path, monkeypatch):
    """Boundaries at 2 and 4; seed 0 improves at 2 only, seed 1 at both:
    each -best triple holds its last improvement, the rolling ones step 4,
    under solo naming, with the solo and the JAX fleet's early-stop counts."""
    _scores(monkeypatch, {0: [0.5, 0.4], 1: [0.5, 0.7]})
    topt, tl = _port(tmp_path, save_checkpoint_every=2)
    res = t_ms.train_multi_seed(topt, tl, 2, max_iterations=5, eval_at_end=False,
                                log_fn=quiet)
    assert res["cider_per_seed"] == [0.5, 0.7]
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{k}_f_{r}{tag}.pkl" for k in ("model", "optimizer", "infos") for r in (0, 1)
        for tag in ("", "-best"))
    for r, best_iter, count in ((0, 3, 2), (1, 5, 1)):
        best, rolling = _infos(tmp_path, "f", r, True), _infos(tmp_path, "f", r, False)
        assert (best["iter"], rolling["iter"]) == (best_iter, 5)
        assert rolling["num_period_best"] == rolling["no_improve"] == count
        assert rolling["best_val_score"] == res["cider_per_seed"][r]
        assert sorted(rolling["val_result_history"]) == [2, 4]
        assert rolling["loss_history"] == res["loss_histories"][r]
        assert "rng_key" not in rolling
    p0_best = t_ckpt.load_checkpoint(str(tmp_path), "f", 0, best=True)[0]
    p0_rolling = t_ckpt.load_checkpoint(str(tmp_path), "f", 0, best=False)[0]
    assert not np.array_equal(p0_best["embed"], p0_rolling["embed"])
    np.testing.assert_array_equal(p0_rolling["embed"], res["params"][0]["embed"].numpy())


def test_fleet_stops_once_every_seed_stagnates(tmp_path, monkeypatch):
    """num_eval_no_improve 3: seed 0's score is constant (stagnant from the
    eval at 6), seed 1 improves at 4 and is stagnant from 8; the fleet runs
    nothing past step 8. The epilogue eval writes nothing (no improvement)."""
    _scores(monkeypatch, {0: [0.5], 1: [0.2, 0.3]})
    topt, tl = _port(tmp_path, save_checkpoint_every=2, num_eval_no_improve=3)
    res = t_ms.train_multi_seed(topt, tl, 2, max_iterations=1000, log_fn=quiet)
    assert max(res["loss_histories"][0]) == 8 and res["iter"] == 9
    assert sorted(res["val_histories"][1]) == [2, 4, 6, 8, 9]
    assert [_infos(tmp_path, "f", r, True)["iter"] for r in (0, 1)] == [3, 5]


def test_preempted_fleet_resumes_as_a_fleet_and_as_one_seed(tmp_path, monkeypatch):
    """Dropout on. SIGTERM after step 2: rolling triples (iter 3) and no
    eval. The fleet resumed from them to step 6 equals the uninterrupted
    fleet bit for bit; seed 1 resumed by the solo loop takes steps 3..5 on
    the fleet's losses."""
    kw = dict(drop_prob_lm=0.3, save_checkpoint_every=100)
    topt, tl = _port(tmp_path / "whole", **kw)
    whole = t_ms.train_multi_seed(topt, tl, 2, max_iterations=6, eval_at_end=False,
                                  save=False, log_fn=quiet)
    with monkeypatch.context() as m:
        _trigger_after(m, 3)
        topt, tl = _port(tmp_path / "pre", **kw)
        pre = t_ms.train_multi_seed(topt, tl, 2, max_iterations=50, log_fn=quiet)
    assert pre["preempted"] and pre["iter"] == 3 and pre["cider_per_seed"] == [None, None]
    assert sorted(os.listdir(tmp_path / "pre")) == sorted(
        f"{k}_f_{r}.pkl" for k in ("model", "optimizer", "infos") for r in (0, 1))
    assert _infos(tmp_path / "pre", "f", 0, False)["iter"] == 3

    topt, tl = _port(tmp_path / "resumed", **kw)
    topt.start_from, topt.load_model_id = str(tmp_path / "pre"), "f"
    resumed = t_ms.train_multi_seed(topt, tl, 2, max_iterations=6, eval_at_end=False,
                                    save=False, log_fn=quiet)
    assert resumed["loss_histories"] == whole["loss_histories"]
    for r in range(2):
        _assert_trees_equal(resumed["params"][r], whole["params"][r])
        _assert_trees_equal(resumed["opt_states"][r].mu, whole["opt_states"][r].mu)

    topt, tl = _port(tmp_path / "solo", **kw)
    topt.start_from, topt.load_model_id = str(tmp_path / "pre"), "f"
    solo = t_train(topt, tl, rank=1, max_iterations=6, log_fn=quiet)
    assert solo["loss_history"] == whole["loss_histories"][1]
    _assert_trees_equal(solo["final_params"], whole["params"][1])


def test_preempted_scst_fleet_resumes_as_a_fleet(tmp_path, monkeypatch):
    """SIGTERM after iteration 1: the --rl_resume fleet continues the
    rollouts' random streams, the moments and the lr base, bit for bit the
    uninterrupted fleet."""
    kw = dict(save_checkpoint_every=100, optim_rl_lr=2e-3)
    topt, tl = _port(tmp_path / "whole", **kw)
    whole = t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=4,
                                     eval_at_end=False, save=False, log_fn=quiet)
    with monkeypatch.context() as m:
        _trigger_after(m, 2)
        topt, tl = _port(tmp_path / "pre", **kw)
        t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=50, log_fn=quiet)
    assert _infos(tmp_path / "pre", "f", 1, False, "rl_")["rl_lr_base"] == 2e-3
    topt, tl = _port(tmp_path / "pre", **kw)
    topt.start_from, topt.load_model_id, topt.rl_resume = str(tmp_path / "pre"), "f", 1
    topt.checkpoint_path = str(tmp_path / "resumed")
    resumed = t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=4,
                                       eval_at_end=False, save=False, log_fn=quiet)
    assert resumed["loss_histories"] == whole["loss_histories"]
    assert resumed["train_loss_histories"][0] == {
        k: v for k, v in whole["train_loss_histories"][0].items() if k >= 2}
    for r in range(2):
        _assert_trees_equal(resumed["params"][r], whole["params"][r])


@pytest.fixture(scope="module")
def xe_fleet(tmp_path_factory):
    """An XE fleet of 2 seeds, a boundary at 2 (the -best triples), the
    epilogue eval at 3: the warm start of the SCST tests below."""
    tmp = tmp_path_factory.mktemp("xe_fleet")
    topt, tl = _port(tmp, "xe", save_checkpoint_every=2)
    res = t_ms.train_multi_seed(topt, tl, 2, max_iterations=3, log_fn=quiet)
    return tmp, res


def _copy_xe(src, dst):
    os.makedirs(dst)
    for name in os.listdir(src):
        if name.endswith(".pkl"):
            with open(os.path.join(src, name), "rb") as f, \
                    open(os.path.join(dst, name), "wb") as g:
                g.write(f.read())


def _pin_best_score(ck, run_id, prefix="", score=1e9, best=True):
    """Rewrite the triples' best score so that the SCST run never beats it."""
    for r in range(2):
        path = os.path.join(ck, f"{prefix}infos_{run_id}_{r}{'-best' if best else ''}.pkl")
        with open(path, "rb") as f:
            infos = pickle.load(f)
        infos["best_val_score"] = score
        with open(path, "wb") as f:
            pickle.dump(infos, f)


def test_scst_warm_start_ships_the_xe_best_of_a_seed_that_never_improves(xe_fleet, tmp_path):
    """Warm start from each rank's XE best triple under --load_lr (moments
    adopted, base = min lr / ratio): with the XE best score out of reach,
    every seed ships the XE weights and moments as its rl_-best, with this
    run's infos."""
    xe_tmp, _ = xe_fleet
    ck = str(tmp_path / "ck")
    _copy_xe(xe_tmp, ck)
    _pin_best_score(ck, "xe")
    topt, tl = _port(ck, "xe", save_checkpoint_every=4)
    topt.start_from, topt.load_model_id, topt.load_lr = ck, "xe", 1
    res = t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=6, log_fn=quiet)
    assert res["iter"] == 6 and res["rl_lr_bases"] == [topt.optim_lr / 2.0] * 2
    assert res["cider_per_seed"] == [1e9, 1e9]
    assert sorted(res["val_histories"][0]) == [2, 4, 6]  # the XE best's eval, then 4, 6
    for r in range(2):
        xe_p, _ = t_ckpt.load_checkpoint(ck, "xe", r, best=True)
        rl_p, infos = t_ckpt.load_checkpoint(ck, "xe", r, best=True, prefix="rl_")
        for a, b in zip(jax.tree_util.tree_leaves(xe_p), jax.tree_util.tree_leaves(rl_p)):
            np.testing.assert_array_equal(a, b)
        xe_o = t_ckpt.load_optimizer(ck, "xe", r, best=True)
        rl_o = t_ckpt.load_optimizer(ck, "xe", r, best=True, prefix="rl_")
        np.testing.assert_array_equal(rl_o[-1].nu["embed"], xe_o[-1].nu["embed"])
        assert infos["best_val_score"] == 1e9 and infos["iter"] == 6
        assert "rl_lr_base" in infos
        rolling = t_ckpt.load_checkpoint(ck, "xe", r, best=False, prefix="rl_")[0]
        assert not np.array_equal(rolling["embed"], rl_p["embed"])


def test_scst_resume_ship_fallback_and_its_guard(xe_fleet, tmp_path, monkeypatch):
    """--rl_resume without an rl_-best: beside an XE best triple, a seed
    that never improves ships it (the fallback); a fleet never warm-started
    has no XE best, so it resumes and its first eval writes the rl_-best
    (the guard)."""
    xe_tmp, _ = xe_fleet
    ck = str(tmp_path / "ck")
    _copy_xe(xe_tmp, ck)
    # a first SCST run preempted before any rl_-best: rolling rl_ triples only
    with monkeypatch.context() as m:
        _trigger_after(m, 1)
        topt, tl = _port(ck, "xe", save_checkpoint_every=100)
        topt.start_from, topt.load_model_id = ck, "xe"
        t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=50, log_fn=quiet)
    assert not t_ckpt.has_checkpoint(ck, "xe", 0, best=True, prefix="rl_")
    _pin_best_score(ck, "xe", prefix="rl_", best=False)
    topt, tl = _port(ck, "xe", save_checkpoint_every=100)
    topt.start_from, topt.load_model_id, topt.rl_resume = ck, "xe", 1
    res = t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=5, log_fn=quiet)
    assert res["cider_per_seed"] == [1e9, 1e9]
    for r in range(2):
        xe_p, _ = t_ckpt.load_checkpoint(ck, "xe", r, best=True)
        rl_p, _ = t_ckpt.load_checkpoint(ck, "xe", r, best=True, prefix="rl_")
        np.testing.assert_array_equal(rl_p["embed"], xe_p["embed"])
        assert t_ckpt.load_optimizer(ck, "xe", r, best=True, prefix="rl_") is not None

    scratch = str(tmp_path / "scratch")
    with monkeypatch.context() as m:
        _trigger_after(m, 1)
        topt, tl = _port(scratch, "s", save_checkpoint_every=100)
        t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=50, log_fn=quiet)
    topt, tl = _port(scratch, "s", save_checkpoint_every=100)
    topt.start_from, topt.load_model_id, topt.rl_resume = scratch, "s", 1
    res = t_ms.train_multi_seed_rl(topt, tl, _scorer(tl), 2, max_iterations=3, log_fn=quiet)
    assert all(s is not None for s in res["cider_per_seed"])
    for r in range(2):
        infos = _infos(scratch, "s", r, True, "rl_")
        assert infos["best_val_score"] == res["cider_per_seed"][r] and infos["iter"] == 3


def test_n_seeds_through_main_and_main_rl(tmp_path):
    """--n_seeds 2 --device cpu: an XE fleet, then an SCST fleet warm-started
    from its -best triples, each seed's triples under its rank."""
    ck = str(tmp_path / "ck")
    common = TINY_FLAGS + ["--checkpoint_path", ck, "--id", "cli", "--val_images_use", "4",
                           "--eval_results_dir", str(tmp_path / "er"), "--n_seeds", "2",
                           "--save_checkpoint_every", "2"]
    xe = t_main.main(common + ["--max_iterations", "3"])
    assert xe["iter"] == 3 and len(xe["params"]) == 2
    rl = t_main_rl.main(common + ["--max_iterations", "5", "--start_from", ck,
                                  "--load_model_id", "cli", "--load_best_score", "0",
                                  "--cider_df", str(tmp_path / "missing.p")])
    assert rl["iter"] == 5 and all(s is not None for s in rl["cider_per_seed"])
    names = set(os.listdir(ck))
    for prefix in ("", "rl_"):
        for r in (0, 1):
            assert {f"{prefix}{k}_cli_{r}{t}.pkl" for k in ("model", "optimizer", "infos")
                    for t in ("", "-best")} <= names


def test_the_jax_ensemble_eval_reads_the_fleets_triples(xe_fleet, tmp_path):
    """The port fleet's -best triples, loaded by the JAX package, decode in
    its eval_ensemble to the port eval_ensemble's predictions."""
    xe_tmp, res = xe_fleet
    jopt, topt, jl, tl = _setups(tmp_path)
    jopt.vocab_size = jl.vocab_size
    jm = j_model(jopt)
    jmembers, tmembers = [], []
    for r in range(2):
        params, opt_state, infos = j_ckpt.load_checkpoint(str(xe_tmp), "xe", r, best=True)
        assert opt_state is not None and infos["iter"] == 3 and infos["no_improve"] >= 1
        jmembers.append((jm, params))
        tmembers.append((res["model"], params_from_jax(params)))
    kw = dict(split="val", beam_size=2, val_images_use=8)
    jpreds, jstats = j_eval_ens(jmembers, jl, jopt, **kw)
    tpreds, tstats = t_eval_ens(tmembers, tl, topt, **kw)
    assert tpreds == jpreds and len(tpreds) == 8
    np.testing.assert_allclose(tstats["CIDEr"], jstats["CIDEr"], rtol=1e-12)
