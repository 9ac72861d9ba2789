"""The port's training and evaluation drivers vs the JAX package's, on the
CPU at tiny widths: ``eval_split``, ``train()`` across eval / checkpoint
boundaries, checkpoint triples in both directions, ``train_rl()`` across a
boundary, the SIGTERM save, the three CLIs and the flags that are not
ported.

Both packages run the synthetic fixture (``data/synthetic.py``, the same
batches from the same seed) at dropout 0 without scheduled sampling, from
the same JAX-initialised params. Tolerances: losses rtol 1e-4 / atol 1e-5;
decoded tokens and therefore predictions identical; language metrics of
identical predictions equal to 1e-12. SCST sampling streams cannot match
JAX's, so train_rl is held port against port (exactly) and its boundary
against the JAX package's eval_split on the same params.
"""

import os
import pickle
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch import config as t_config
from recurrent_fusion_network_torch import feat_registry as t_registry
from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.data.synthetic import synthetic_setup as t_setup
from recurrent_fusion_network_torch.decoding.api import model_sample as t_sample
from recurrent_fusion_network_torch.models import setup as t_model
from recurrent_fusion_network_torch.ops.initializers import tree_map
from recurrent_fusion_network_torch.data.prepro_ngrams import compute_doc_freq
from recurrent_fusion_network_torch.rewards.cider_d import CiderD
from recurrent_fusion_network_torch.training import checkpoint as t_ckpt
from recurrent_fusion_network_torch.training.eval_split import eval_split as t_eval
from recurrent_fusion_network_torch.training.optim import AdamState
from recurrent_fusion_network_torch.training.train_loop import (RNG_KEY, save_triple,
                                                                snapshot_opt)
from recurrent_fusion_network_torch.training.train_loop import train as t_train
from recurrent_fusion_network_torch.training.train_rl_loop import train_rl as t_train_rl
from recurrent_fusion_network_tpu.data.synthetic import synthetic_setup as j_setup
from recurrent_fusion_network_tpu.decoding.api import model_sample as j_sample
from recurrent_fusion_network_tpu.models import setup as j_model
from recurrent_fusion_network_tpu.training import checkpoint as j_ckpt
from recurrent_fusion_network_tpu.training.eval_split import eval_split as j_eval
from recurrent_fusion_network_tpu.training.train_loop import train as j_train

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE")


def quiet(*_):
    pass


def _setups(tmp, **over):
    """(jopt, topt, JAX loader, port loader) of the synthetic fixture: 3
    encoders, width 16, 2 + 2 review steps, 4 images x 2 captions a batch."""
    kw = dict(batch_size=4, seq_per_img=2, losses_log_every=1,
              eval_results_dir=os.path.join(str(tmp), "eval_results"), **over)
    jopt, jl = j_setup(**kw)
    topt, tl = t_setup(**kw, device="cpu")
    return jopt, topt, jl, tl


def _jax_params(jopt, seed=7):
    return jax.tree_util.tree_map(np.asarray,
                                  j_model(jopt).init_params(jax.random.PRNGKey(seed)))


def _zero_checkpoint(path, jopt, params):
    """A JAX-written triple at iteration 0: both packages' runs start from it."""
    j_ckpt.save_checkpoint(str(path), "zero", 0, params=params,
                           infos={"iter": 0, "epoch": 0, "opt": dict(vars(jopt))})


def _assert_stats_equal(a, b):
    assert sorted(a) == sorted(b) == sorted(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12, err_msg=k)
        assert np.isfinite(a[k]), k


def _assert_eval_equal(t, j, with_loss=True):
    (tl, tp, ts), (jl, jp, js) = t, j
    assert tp == jp
    if with_loss:
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    _assert_stats_equal(ts, js)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_eval_split_matches_jax(tmp_path, beam_size):
    """Same params, same val batches: identical greedy / beam-3 predictions,
    the loss within rtol 1e-4 and equal metrics."""
    jopt, topt, jl, tl = _setups(tmp_path, beam_size=beam_size)
    jopt.vocab_size = topt.vocab_size = jl.vocab_size
    p = _jax_params(jopt)
    j = j_eval(j_model(jopt), p, jl, jopt, split="val")
    t = t_eval(t_model(topt), params_from_jax(p), tl, topt, split="val")
    assert len(t[1]) == len(tl.split_image_id["val"])
    _assert_eval_equal(t, j)


@pytest.fixture(scope="module")
def xe_runs(tmp_path_factory):
    """JAX and port train() from one JAX-written params triple, 5 steps
    with eval / checkpoint boundaries at 2 and 4 (greedy, CIDEr-gated)."""
    tmp = tmp_path_factory.mktemp("xe")
    jopt, topt, jl, tl = _setups(tmp, save_checkpoint_every=2)
    jopt.vocab_size = jl.vocab_size
    _zero_checkpoint(tmp / "start", jopt, _jax_params(jopt))
    out = {}
    for name, opt, loader, train in (("jax", jopt, jl, j_train), ("port", topt, tl, t_train)):
        opt.start_from, opt.load_model_id = str(tmp / "start"), "zero"
        opt.checkpoint_path, opt.id = str(tmp / name), "run"
        out[name] = train(opt, loader, max_iterations=5, log_fn=quiet)
    return tmp, jopt, topt, out


def test_train_matches_jax_across_two_boundaries(xe_runs):
    """Loss history within rtol 1e-4, identical val predictions and equal
    metrics at both boundaries, the same best iterations and the same
    checkpoint files."""
    tmp, _, _, out = xe_runs
    j, t = out["jax"], out["port"]
    assert t["iter"] == j["iter"] == 5
    assert sorted(t["loss_history"]) == sorted(j["loss_history"]) == list(range(5))
    np.testing.assert_allclose([t["loss_history"][i] for i in range(5)],
                               [j["loss_history"][i] for i in range(5)], rtol=RTOL)
    assert sorted(t["val_result_history"]) == sorted(j["val_result_history"]) == [2, 4]
    for it in (2, 4):
        tv, jv = t["val_result_history"][it], j["val_result_history"][it]
        _assert_eval_equal((tv["loss"], tv["predictions"], tv["lang_stats"]),
                           (jv["loss"], jv["predictions"], jv["lang_stats"]))
    assert sorted(os.listdir(tmp / "port")) == sorted(os.listdir(tmp / "jax"))
    for best in (False, True):
        _, _, ji = j_ckpt.load_checkpoint(str(tmp / "jax"), "run", 0, best=best)
        _, ti = t_ckpt.load_checkpoint(str(tmp / "port"), "run", 0, best=best)
        assert ti["iter"] == ji["iter"] and ti["best_val_score"] == pytest.approx(
            ji["best_val_score"], rel=1e-12)
        assert ti["num_period_best"] == ji["num_period_best"]


def test_train_stops_after_num_eval_no_improve(tmp_path):
    """num_eval_no_improve 1: the first eval is the best one and already
    the stop (as in the JAX package): one triple and its best copy."""
    jopt, topt, jl, tl = _setups(tmp_path, save_checkpoint_every=2, num_eval_no_improve=1)
    for name, opt, loader, train in (("jax", jopt, jl, j_train), ("port", topt, tl, t_train)):
        opt.checkpoint_path, opt.id = str(tmp_path / name), "stop"
        info = train(opt, loader, max_iterations=9, log_fn=quiet)
        assert info["iter"] == 3, name
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_port_resume_equals_the_uninterrupted_run(tmp_path):
    """With dropout on: 3 steps (a triple at the boundary 2), then a resume
    from it to step 5, equals 5 steps in one run: losses, params, Adam
    moments, evals, the best score bit for bit."""
    runs = {}
    for name, first in (("whole", 5), ("split", 3)):
        _, topt, _, tl = _setups(tmp_path, save_checkpoint_every=2, drop_prob_lm=0.3)
        topt.checkpoint_path, topt.id = str(tmp_path / name), "run"
        runs[name] = t_train(topt, tl, max_iterations=first, log_fn=quiet)
    _, topt, _, tl = _setups(tmp_path, save_checkpoint_every=2, drop_prob_lm=0.3)
    topt.start_from, topt.load_model_id = str(tmp_path / "split"), "run"
    topt.checkpoint_path, topt.id = str(tmp_path / "resumed"), "run"
    resumed = t_train(topt, tl, max_iterations=5, log_fn=quiet)
    whole = runs["whole"]
    assert resumed["iter"] == 5 and resumed["loss_history"] == whole["loss_history"]
    assert resumed["best_val_score"] == whole["best_val_score"]
    assert resumed["val_result_history"][4] == whole["val_result_history"][4]
    for a, b in zip(jax.tree_util.tree_leaves(tree_map(lambda x: x.numpy(), whole["final_params"])),
                    jax.tree_util.tree_leaves(tree_map(lambda x: x.numpy(),
                                                       resumed["final_params"]))):
        np.testing.assert_array_equal(a, b)
    assert resumed["final_opt_state"].count == whole["final_opt_state"].count == 5
    np.testing.assert_array_equal(resumed["final_opt_state"].nu["logit"]["w"].numpy(),
                                  whole["final_opt_state"].nu["logit"]["w"].numpy())


def test_jax_reads_and_resumes_a_port_written_triple(xe_runs):
    """The port's non-best triple after step 4: the JAX package loads it,
    its model decodes the port's greedy and beam-3 tokens, and a JAX train()
    resume from it takes step 5 at the port's loss within rtol 1e-4."""
    tmp, jopt, topt, _ = xe_runs
    params, opt_state, infos = j_ckpt.load_checkpoint(str(tmp / "port"), "run", 0, best=False)
    assert infos["iter"] == 5 and opt_state[-1].count.dtype == np.int32
    assert "rng_key" not in infos and RNG_KEY in infos
    jm, tm = j_model(jopt), t_model(topt)
    g = np.random.default_rng(0)
    fc = [g.standard_normal((3, f["fc_feat_size"])).astype(np.float32)
          for f in jopt.feat_array_info]
    att = [g.standard_normal((3, f["att_num"], f["att_feat_size"])).astype(np.float32)
           for f in jopt.feat_array_info]
    tp = params_from_jax(t_ckpt.load_checkpoint(str(tmp / "port"), "run", 0, best=False)[0])
    for beam in (1, 3):
        j = j_sample(jm, params, fc, att, beam_size=beam)
        with torch.no_grad():
            t = t_sample(tm, tp, [torch.from_numpy(x) for x in fc],
                         [torch.from_numpy(x) for x in att], beam_size=beam)
        np.testing.assert_array_equal(t.seq.numpy(), np.asarray(j.seq))

    runs = {}
    for name, opt, train in (("jax", jopt, j_train), ("port", topt, t_train)):
        loader = (j_setup if name == "jax" else t_setup)(
            batch_size=4, seq_per_img=2, **({} if name == "jax" else {"device": "cpu"}))[1]
        opt.start_from, opt.load_model_id = str(tmp / "port"), "run"
        opt.checkpoint_path, opt.id = str(tmp / f"resume_{name}"), "run"
        runs[name] = train(opt, loader, max_iterations=6, log_fn=quiet)
    np.testing.assert_allclose(runs["port"]["loss_history"][5], runs["jax"]["loss_history"][5],
                               rtol=RTOL)


def test_port_triple_traps(tmp_path):
    """The three ways a port-written triple could load silently wrong in the
    JAX package: registry encoders stay EncoderInfo (not dicts, which JAX's
    eval would feed synthetic features), tied_att_keys is stored resolved,
    and the infos carry no rng_key."""
    from recurrent_fusion_network_tpu import feat_registry as j_registry
    from recurrent_fusion_network_tpu.config import Options as JaxOptions
    from recurrent_fusion_network_tpu.data.build import _source_for

    topt = t_config.Options(feat_array_info=t_registry.feat_array_info(str(tmp_path)),
                            tied_att_keys=-1, feature_type="feat_array", id="trap",
                            checkpoint_path=str(tmp_path), optim_weight_decay=0.0)
    params = {"w": torch.ones(2, 3)}
    state = AdamState(count=3, mu={"w": torch.zeros(2, 3)}, nu={"w": torch.ones(2, 3)})
    infos = {"iter": 1, "opt": snapshot_opt(topt),
             RNG_KEY: torch.Generator().manual_seed(1).get_state().numpy()}
    save_triple(topt, 0, params, state, infos, best=True)
    p, o, i = j_ckpt.load_checkpoint(str(tmp_path), "trap", 0)
    fai = i["opt"]["feat_array_info"]
    assert all(type(e) is j_registry.EncoderInfo for e in fai)
    assert fai == j_registry.feat_array_info(str(tmp_path))
    assert i["opt"]["tied_att_keys"] == 1 and "rng_key" not in i
    assert type(o[0]).__name__ == "EmptyState" and len(o) == 2
    assert o[1].count == 3 and o[1].count.dtype == np.int32
    np.testing.assert_array_equal(o[1].nu["w"], np.ones((2, 3), np.float32))
    jopt = JaxOptions(feature_type="feat_array", data_root=str(tmp_path))
    assert type(_source_for(fai[0], str(tmp_path))).__name__ == "DirFeatureSource"
    assert jopt.tied_att_keys == i["opt"]["tied_att_keys"]
    # and the port reads back what it wrote
    tp, ti = t_ckpt.load_checkpoint(str(tmp_path), "trap", 0)
    assert all(type(e) is t_registry.EncoderInfo for e in ti["opt"]["feat_array_info"])
    saved = t_ckpt.load_optimizer(str(tmp_path), "trap", 0)
    assert int(saved[-1].count) == 3
    # a params-only save retires the tag's optimizer file
    t_ckpt.save_checkpoint(str(tmp_path), "trap", 0, params={"w": np.ones(2)}, best=True)
    assert not os.path.exists(tmp_path / "optimizer_trap_0-best.pkl")
    assert t_ckpt.has_checkpoint(str(tmp_path), "trap", 0)


def _scorer(loader):
    ids = loader.split_image_id["train"]
    return CiderD(compute_doc_freq(loader.dataset, ids), float(np.log(len(ids))))


@pytest.fixture(scope="module")
def rl_runs(xe_runs, tmp_path_factory):
    """train_rl warm-started from the port's XE best triple (saved at the
    boundary 2, so the run continues at iteration 3): iterations 3..5 with
    the boundary at 4, under --rl_overlap 1 and 0."""
    xe_tmp = xe_runs[0]
    tmp = tmp_path_factory.mktemp("rl")
    out = {}
    for overlap in (1, 0):
        _, topt, _, tl = _setups(tmp, save_checkpoint_every=4, rl_overlap=overlap,
                                 load_best_score=0)
        topt.start_from, topt.load_model_id = str(xe_tmp / "port"), "run"
        topt.checkpoint_path, topt.id = str(tmp / f"o{overlap}"), "rl"
        out[overlap] = t_train_rl(topt, tl, _scorer(tl), max_iterations=6, log_fn=quiet)
    return tmp, out


def test_train_rl_overlap_and_files_match_the_serial_loop(rl_runs):
    tmp, out = rl_runs
    a, b = out[1], out[0]
    assert a["iter"] == b["iter"] == 6
    assert a["loss_history"] == b["loss_history"]
    assert a["train_loss_history"] == b["train_loss_history"]
    assert sorted(a["val_result_history"]) == [2, 4]  # the XE boundary 2, then 4
    assert a["val_result_history"] == b["val_result_history"]
    assert sorted(os.listdir(tmp / "o1")) == sorted(os.listdir(tmp / "o0")) == sorted(
        f"rl_{k}_rl_0{s}.pkl" for k in ("model", "optimizer", "infos") for s in ("", "-best"))


def test_train_rl_resume_equals_the_uninterrupted_run(rl_runs, tmp_path):
    """--rl_resume from the rl_ triple of the boundary 4 (iter 5): step 5's
    reward, loss and params are the uninterrupted run's, its multinomial
    draws continuing the saved random stream."""
    tmp, out = rl_runs
    _, topt, _, tl = _setups(tmp_path, save_checkpoint_every=4, load_best_score=0)
    topt.start_from, topt.load_model_id, topt.rl_resume = str(tmp / "o1"), "rl", 1
    topt.checkpoint_path, topt.id = str(tmp_path / "resumed"), "rl"
    resumed = t_train_rl(topt, tl, _scorer(tl), max_iterations=6, log_fn=quiet)
    whole = out[1]
    assert resumed["loss_history"][5] == whole["loss_history"][5]
    assert resumed["train_loss_history"] == {5: whole["train_loss_history"][5]}
    for a, b in zip(jax.tree_util.tree_leaves(tree_map(lambda x: x.numpy(), whole["final_params"])),
                    jax.tree_util.tree_leaves(tree_map(lambda x: x.numpy(),
                                                       resumed["final_params"]))):
        np.testing.assert_array_equal(a, b)


def test_train_rl_boundary_matches_jax_eval_and_loads_in_jax(rl_runs, tmp_path):
    """The rl_ triple loads in the JAX package, and the JAX eval_split of
    its params gives the boundary's predictions and metrics."""
    tmp, out = rl_runs
    params, opt_state, infos = j_ckpt.load_checkpoint(str(tmp / "o1"), "rl", 0, best=False,
                                                      prefix="rl_")
    assert infos["iter"] == 5 and "rl_lr_base" in infos and opt_state is not None
    jopt, _, jl, _ = _setups(tmp_path)
    jopt.vocab_size = jl.vocab_size
    j = j_eval(j_model(jopt), params, jl, jopt, split="val")
    v = out[1]["val_result_history"][4]
    _assert_eval_equal((v["loss"], v["predictions"], v["lang_stats"]), j, with_loss=False)


def test_sigterm_saves_a_triple_and_the_run_resumes(tmp_path):
    """SIGTERM during step 1: the loop saves at the next boundary check (iter
    2, recorded as iter 3) and stops; a resume from that triple continues
    with step 3 on the uninterrupted run's loss."""
    assert threading.current_thread() is threading.main_thread()
    _, topt, _, tl = _setups(tmp_path)
    topt.checkpoint_path, topt.id = str(tmp_path / "pre"), "run"
    before = signal.getsignal(signal.SIGTERM)

    def log_fn(line):
        if line.startswith("rank 0, iter 1,"):
            handler = signal.getsignal(signal.SIGTERM)
            assert getattr(handler, "__self__", None).__class__.__name__ == "PreemptGuard"
            os.kill(os.getpid(), signal.SIGTERM)

    info = t_train(topt, tl, max_iterations=9, log_fn=log_fn)
    assert info["iter"] == 3 and signal.getsignal(signal.SIGTERM) == before
    _, saved = t_ckpt.load_checkpoint(str(tmp_path / "pre"), "run", 0, best=False)
    assert saved["iter"] == 3
    _, topt, _, tl = _setups(tmp_path)
    topt.start_from, topt.load_model_id = str(tmp_path / "pre"), "run"
    topt.checkpoint_path = str(tmp_path / "post")
    resumed = t_train(topt, tl, max_iterations=5, log_fn=quiet)
    _, topt, _, tl = _setups(tmp_path)
    topt.checkpoint_path = str(tmp_path / "whole")
    whole = t_train(topt, tl, max_iterations=5, log_fn=quiet)
    assert sorted(resumed["loss_history"]) == [0, 1, 2, 3, 4]
    assert [resumed["loss_history"][i] for i in (3, 4)] == [whole["loss_history"][i]
                                                            for i in (3, 4)]


TINY_FLAGS = ["--device", "cpu", "--feature_type", "synthetic",
              "--caption_model", "recurrent_fusion_model", "--rnn_size", "16",
              "--input_encoding_size", "16", "--att_hid_size", "16", "--num_review_steps", "2",
              "--num_review_steps_0", "2", "--batch_size", "4", "--seq_per_img", "2"]


def test_the_three_clis_run_in_process(tmp_path, capsys):
    from recurrent_fusion_network_torch import eval as t_eval_cli
    from recurrent_fusion_network_torch import main as t_main
    from recurrent_fusion_network_torch import main_rl as t_main_rl

    ck = str(tmp_path / "ck")
    common = TINY_FLAGS + ["--checkpoint_path", ck, "--id", "cli", "--val_images_use", "8",
                           "--eval_results_dir", str(tmp_path / "er"),
                           "--json_log", str(tmp_path / "log.jsonl")]
    info = t_main.main(common + ["--max_iterations", "3", "--save_checkpoint_every", "2"])
    assert info["iter"] == 3
    assert {f"{k}_cli_0{s}.pkl" for k in ("model", "optimizer", "infos")
            for s in ("", "-best")} <= set(os.listdir(ck))
    rl = t_main_rl.main(common + ["--max_iterations", "6", "--save_checkpoint_every", "2",
                                  "--start_from", ck, "--load_model_id", "cli",
                                  "--load_best_score", "0",
                                  "--cider_df", str(tmp_path / "missing.p")])
    assert rl["iter"] == 6 and os.path.exists(os.path.join(ck, "rl_model_cli_0-best.pkl"))
    capsys.readouterr()
    for rl_prefix in ("0", "1"):
        loss, preds, stats = t_eval_cli.main([
            "--device", "cpu", "--model_path", ck, "--load_model_id", "cli", "--beam_size",
            "3", "--rl_prefix", rl_prefix, "--eval_results_dir", str(tmp_path / "er")])
        printed = capsys.readouterr().out
        assert f"loss: {loss:.4f}" in printed and len(preds) == 8
        for k in METRICS:
            assert f"{k}: " in printed and np.isfinite(stats[k])
    with open(tmp_path / "log.jsonl") as f:
        events = [line for line in f]
    assert any('"event": "val"' in e for e in events) and any('"rl_val"' in e for e in events)


@pytest.mark.parametrize("flag, value, entry", [
    ("checkpoint_backend", "orbax", "M11"), ("profile_steps", "3", "M11"),
    ("eval_ensemble_multi_gpu", "1", "M10"), ("num_dp_devices", "2", "M10"),
    ("num_mp_devices", "2", "M10"),
    ("async_opt", "1", "M10")])
def test_unported_flags_raise(flag, value, entry):
    with pytest.raises(NotImplementedError, match=entry):
        t_config.parse_opt(["--device", "cpu", "--feature_type", "synthetic",
                            f"--{flag}", value])


def test_options_snapshot_pickles_for_both_packages(tmp_path):
    """A port opt snapshot with registry encoders round-trips through the
    writer and both readers with every flag the JAX parser knows."""
    from recurrent_fusion_network_tpu.config import parse_opt as j_parse

    topt = t_config.parse_opt(["--device", "cpu", "--feature_type", "feat_array",
                               "--data_root", str(tmp_path)])
    jopt = j_parse(["--feature_type", "feat_array", "--data_root", str(tmp_path)])
    assert set(vars(jopt)) - set(vars(topt)) <= {"port"} | {
        k for k in vars(jopt) if k.startswith("input_")}
    t_ckpt.save_checkpoint(str(tmp_path), "o", 0, params={}, infos={"opt": vars(topt)})
    with open(tmp_path / "infos_o_0.pkl", "rb") as f:
        got = pickle.load(f)["opt"]
    assert got["feat_array_info"] == jopt.feat_array_info


# the port's flags the JAX package's parse_opt does not have, each with the
# reason it has them; every flag both have takes the same default
PORT_ONLY_FLAGS = {
    "device": "entry points run on CUDA unless --device cpu",
    "host": "the serve CLI's HTTP address (the JAX root serve.py's own parser)",
    "rank": "the checkpoint rank the eval and serve CLIs load",
    "rl_prefix": "eval and serve load the rl_ (SCST) triple",
    "serve_batch_size": "the serve CLI's batch", "serve_depth": "batches in flight",
    "drain_timeout": "the serve CLI's SIGTERM drain",
    "serve_dtype": "the serve CLI's weights' dtype",
    "eval_results_dir": "where eval_split writes its per-image metric JSONs",
}


def test_parse_opt_defaults_equal_the_jax_packages():
    """Every flag both packages' parse_opt([]) have takes the same default:
    --port is the SPICE service's 8090 and --caption_model is show_tell;
    the serve CLI's --port, its HTTP front end's, is 8080."""
    from recurrent_fusion_network_tpu.config import parse_opt as j_parse

    topt, jopt = vars(t_config.parse_opt([])), vars(j_parse([]))
    assert set(topt) - set(jopt) == set(PORT_ONLY_FLAGS) == t_config.PORT_ONLY
    assert set(jopt) <= set(topt)
    differ = {k: (topt[k], jopt[k]) for k in jopt if k != "feat_array_info" and topt[k] != jopt[k]}
    assert differ == {}
    assert [dict(e) for e in topt["feat_array_info"]] == [dict(e) for e in jopt["feat_array_info"]]
    assert topt["port"] == 8090 and topt["caption_model"] == "show_tell"
    assert t_config.parse_serve_opt([]).port == 8080


def test_a_port_triples_saved_opt_holds_the_jax_keys_only(xe_runs, tmp_path):
    """The saved opt of a port triple (a feat_array run) and a port opt
    snapshot of a registry encoder (with its input_*_dir paths) have
    exactly the keys of the JAX package's options for the same flags."""
    from recurrent_fusion_network_tpu.config import parse_opt as j_parse

    tmp = xe_runs[0]
    _, infos = t_ckpt.load_checkpoint(str(tmp / "port"), "run", 0, best=False)
    jopt = j_parse(["--feature_type", "feat_array", "--data_root", str(tmp_path)])
    assert set(infos["opt"]) == set(vars(jopt))
    flags = ["--feature_type", "inception_v3", "--data_root", str(tmp_path)]
    saved = snapshot_opt(t_config.parse_opt(["--device", "cpu"] + flags))
    assert set(saved) == set(vars(j_parse(flags)))
    assert not set(saved) & t_config.PORT_ONLY


def test_jax_eval_of_a_port_triple_writes_under_eval_results(xe_runs, tmp_path,
                                                             monkeypatch, capsys):
    """The JAX eval CLI on a port-written triple (whose training run wrote
    its eval JSONs elsewhere) writes its per-image metric JSONs where it
    would for its own triple: eval_results under the working directory."""
    import importlib.util
    import sys

    tmp = xe_runs[0]
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "eval.py")
    spec = importlib.util.spec_from_file_location("jax_eval_cli", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [
        "eval.py", "--model_path", str(tmp / "port"), "--load_model_id", "run",
        "--eval_split", "val", "--val_images_use", "4", "--batch_size", "4",
        "--seq_per_img", "2", "--synthetic_features", "1"])
    cli.main()
    assert "CIDEr: " in capsys.readouterr().out
    written = os.listdir(tmp_path / "eval_results")
    assert written and all(f.endswith(".json") for f in written)
