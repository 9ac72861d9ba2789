"""The port's ensemble decoding and ensemble eval vs the JAX package's, f32
on the CPU at tiny widths.

Members are JAX-initialised and converted with ``params_from_jax``; inputs
come from numpy seeds or the synthetic fixture (the same batches in both
packages). Tolerances: log-probs and states rtol 1e-4 / atol 1e-5; greedy
and beam tokens, and therefore predictions, identical; sentence log-probs
of the same arrays equal (both packages sum them in numpy).
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch import eval_ensemble as t_cli
from recurrent_fusion_network_torch.config import Options as TorchOptions
from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.data.synthetic import synthetic_setup as t_setup
from recurrent_fusion_network_torch.decoding import engine as t_engine
from recurrent_fusion_network_torch.decoding import ensemble as t_ens
from recurrent_fusion_network_torch.decoding.api import model_sample as t_sample
from recurrent_fusion_network_torch.models import setup as t_model
from recurrent_fusion_network_torch.training.eval_ensemble import eval_ensemble as t_eval
from recurrent_fusion_network_tpu.config import Options as JaxOptions
from recurrent_fusion_network_tpu.data.synthetic import synthetic_setup as j_setup
from recurrent_fusion_network_tpu.decoding import engine as j_engine
from recurrent_fusion_network_tpu.decoding import ensemble as j_ens
from recurrent_fusion_network_tpu.models import setup as j_model
from recurrent_fusion_network_tpu.training import checkpoint as j_ckpt
from recurrent_fusion_network_tpu.training.eval_ensemble import eval_ensemble as j_eval

from _single_encoder_parity import options as single_options
from test_torch_model import TINY, features

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RFNET = dict(caption_model="recurrent_fusion_model", rnn_size=16, input_encoding_size=16,
             att_hid_size=16, num_review_steps=2, num_review_steps_0=2, top_words_count=12)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _rfnet_options(tied):
    feats = [{"fc_feat_size": f, "att_feat_size": a, "att_num": n}
             for f, a, n in zip(TINY["fc_feat_sizes"], TINY["att_feat_sizes"],
                                TINY["att_nums"])]
    kw = dict(RFNET, feat_array_info=feats, tied_att_keys=int(tied))
    jopt, topt = JaxOptions(feature_type="feat_array", **kw), TorchOptions(**kw)
    for o in (jopt, topt):
        o.vocab_size, o.seq_length = TINY["vocab_size"], TINY["seq_length"]
    return jopt, topt


def _member(jopt, topt, seed):
    """(JAX model, JAX params as numpy, port model, port params)."""
    jm, tm = j_model(jopt), t_model(topt)
    jp = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    return jm, jp, tm, params_from_jax(jp)


def _members(case):
    """Members and (fc list, att list) of a step-function case."""
    if case in ("rfnet", "mixed_tied_untied"):
        tied = (True, case == "rfnet")
        return ([_member(*_rfnet_options(t), seed) for seed, t in enumerate(tied)],
                features(seed=3, batch=4))
    # a MoS ReviewNet (its mixture probabilities) beside a plain one
    members = [_member(*single_options("review_net", use_mos=1, num_expert=3), 0),
               _member(*single_options("review_net"), 1)]
    g = np.random.default_rng(3)
    fc, att = g.standard_normal((4, 12)).astype(np.float32), g.standard_normal(
        (4, 5, 10)).astype(np.float32)
    return members, ([fc], [att])


def _as_torch(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("case", ["rfnet", "mixed_tied_untied", "mos_review_net"])
def test_ensemble_step_matches_jax(case):
    """Three steps of the mean-logit step from each member's encoding: the
    log-probs and every member's carried state."""
    members, (fcs, atts) = _members(case)
    jtrip, ttrip, jstates, tstates = [], [], [], []
    for jm, jp, tm, tp in members:
        jenc = jm.encode(jp, fcs if len(fcs) > 1 else fcs[0], atts if len(atts) > 1 else atts[0])
        tenc = tm.encode(tp, _as_torch(fcs), _as_torch(atts))
        jtrip.append((jm, jp, jenc.memory))
        ttrip.append((tm, tp, tenc.memory))
        jstates.append(jenc.state)
        tstates.append(tenc.state)
    jstep, tstep = j_engine.make_ensemble_step_fn(jtrip), t_engine.make_ensemble_step_fn(ttrip)
    jstates, tstates = tuple(jstates), tuple(tstates)
    tokens = np.random.default_rng(5).integers(1, members[0][2].vocab_size + 1, (3, 4))
    tokens[0] = 0
    with torch.no_grad():
        for tok in tokens:
            jlp, jstates = jstep(tok, jstates)
            tlp, tstates = tstep(torch.from_numpy(tok), tstates)
            assert tlp.dtype == torch.float32
            _close(tlp, jlp)
            for a, b in zip(jax.tree_util.tree_leaves(jstates),
                            jax.tree_util.tree_leaves(tstates), strict=True):
                _close(b, a)
    if case == "mos_review_net":
        # the quirk: a one-member MoS ensemble log-softmaxes probabilities
        jm, jp, tm, tp = members[0]
        one = t_engine.make_ensemble_step_fn([ttrip[0]])
        solo_step = t_engine.make_step_fn(tm, tp, ttrip[0][2])
        with torch.no_grad():
            x = torch.zeros(4, dtype=torch.long)
            lp_one, _ = one(x, (tstates[0],))
            lp_solo, _ = solo_step(x, tstates[0])
        assert (lp_one.exp().sum(-1) - 1).abs().max() < 1e-5
        assert not torch.allclose(lp_one, lp_solo, atol=1e-3)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_one_member_ensemble_is_the_models_decode(beam_size):
    (_, _, tm, tp), = [_member(*_rfnet_options(True), 0)]
    fcs, atts = _as_torch(features(seed=4, batch=5)[0]), _as_torch(features(seed=4, batch=5)[1])
    with torch.no_grad():
        solo = t_sample(tm, tp, fcs, atts, beam_size=beam_size)
        ens = t_ens.ensemble_sample([tm], [tp], [(fcs, atts)], beam_size=beam_size)
    assert torch.equal(ens.seq, solo.seq)
    torch.testing.assert_close(ens.seq_logprobs, solo.seq_logprobs, rtol=1e-6, atol=1e-6)
    if beam_size > 1:
        assert torch.equal(ens.top_seq, solo.top_seq)
        torch.testing.assert_close(ens.top_p, solo.top_p, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_two_member_ensemble_sample_matches_jax(beam_size):
    """Tied and untied RFNet members: tokens identical, sentence and beam
    log-probs within tolerance; the ensemble differs from either member."""
    members = [_member(*_rfnet_options(t), s) for s, t in ((0, True), (1, False))]
    fcs, atts = features(seed=6, batch=5)
    jm_list, jp_list = [m[0] for m in members], [m[1] for m in members]
    jout = jax.jit(lambda ps, f: j_ens.ensemble_sample(jm_list, ps, f, beam_size=beam_size))(
        jp_list, [(fcs, atts)] * 2)
    with torch.no_grad():
        tout = t_ens.ensemble_sample([m[2] for m in members], [m[3] for m in members],
                                     [(_as_torch(fcs), _as_torch(atts))] * 2,
                                     beam_size=beam_size)
        solo = t_sample(members[0][2], members[0][3], _as_torch(fcs), _as_torch(atts),
                        beam_size=beam_size)
    np.testing.assert_array_equal(tout.seq.numpy(), np.asarray(jout.seq))
    _close(tout.seq_logprobs, jout.seq_logprobs)
    if beam_size > 1:
        np.testing.assert_array_equal(tout.top_seq.numpy(), np.asarray(jout.top_seq))
        _close(tout.top_p, jout.top_p)
    else:
        assert tout.top_seq is None and tout.top_p is None
    assert not torch.allclose(tout.seq_logprobs, solo.seq_logprobs)


def test_sentence_logprob_and_flip_combine_match_jax():
    """EOS-cut rows (the EOS step and what follows it left out), an exact
    tie (the flipped decode wins) and a random case: the same picks and
    log-probs as the JAX package, from tensors and from arrays."""
    a_seq = np.array([[3, 0, 0], [3, 4, 0], [5, 0, 0], [2, 2, 2]])
    a_lp = np.array([[-1.0, -3.0, 0.0], [-2.0, -0.5, -9.0], [-1.0, -5.0, 0.0],
                     [-0.1, -0.1, -0.1]], np.float32)
    b_seq = np.array([[4, 5, 0], [6, 0, 0], [4, 0, 0], [1, 0, 0]])
    b_lp = np.array([[-1.2, -1.2, -0.1], [-2.4, -0.1, 0.0], [-1.0, -0.2, 0.0],
                     [-0.4, -2.0, 0.0]], np.float32)
    g = np.random.default_rng(0)
    r_seq = [g.integers(0, 4, (6, 5)) for _ in range(2)]
    r_lp = [-g.random((6, 5)).astype(np.float32) for _ in range(2)]
    for (sa, la), (sb, lb) in (((a_seq, a_lp), (b_seq, b_lp)),
                               ((r_seq[0], r_lp[0]), (r_seq[1], r_lp[1]))):
        want_p = j_ens.sentence_logprob(sa, la)
        np.testing.assert_array_equal(t_ens.sentence_logprob(torch.from_numpy(sa),
                                                             torch.from_numpy(la)), want_p)
        jseq, jp = j_ens.flip_combine(j_ens.EnsembleOut(sa, la, None, None),
                                      j_ens.EnsembleOut(sb, lb, None, None))
        for conv in (torch.from_numpy, np.asarray):
            tseq, tp = t_ens.flip_combine(t_ens.EnsembleOut(conv(sa), conv(la), None, None),
                                          t_ens.EnsembleOut(conv(sb), conv(lb), None, None))
            np.testing.assert_array_equal(tseq, jseq)
            np.testing.assert_array_equal(tp, jp)
    seq, _ = t_ens.flip_combine(t_ens.EnsembleOut(a_seq, a_lp, None, None),
                                t_ens.EnsembleOut(b_seq, b_lp, None, None))
    # a: EOS-excluded -1 beats -2.4; b wins the tie at -1; the last row
    # counts every step of a full-length a
    np.testing.assert_array_equal(seq, np.stack([a_seq[0], b_seq[1], b_seq[2], a_seq[3]]))


def _loaders(tmp_path, **over):
    kw = dict(batch_size=4, seq_per_img=2, eval_results_dir=str(tmp_path / "er"), **over)
    jopt, jl = j_setup(**kw)
    topt, tl = t_setup(**kw, device="cpu")
    return jopt, topt, jl, tl


def _fixture_members(jopt, topt, seeds=(0, 1), tied=(True, True)):
    out = []
    for seed, t in zip(seeds, tied):
        jopt.tied_att_keys = topt.tied_att_keys = int(t)
        out.append(_member(jopt, topt, seed))
    return out


def _review_members(jopt, topt, n):
    """One ReviewNet per encoder of the fixture, each on its encoder's
    widths (the diff-feat ensemble)."""
    out = []
    for i in range(n):
        kw = dict(caption_model="review_net", feat_array_info=[jopt.feat_array_info[i]],
                  rnn_size=16, input_encoding_size=16, att_hid_size=16, num_review_steps=2,
                  top_words_count=jopt.top_words_count)
        jo, to = JaxOptions(feature_type="synthetic", **kw), TorchOptions(**kw)
        for o in (jo, to):
            o.vocab_size, o.seq_length = jopt.vocab_size, jopt.seq_length
        to.tied_att_keys = jo.tied_att_keys
        out.append(_member(jo, to, 10 + i))
    return out


@pytest.mark.parametrize("mode", ["plain", "flip", "diff_feat"])
def test_eval_ensemble_matches_jax(tmp_path, mode):
    """The synthetic fixture's val split, 8 images: plain (two RFNet
    members, beam 3), --eval_flip_ensemble 1 (beam 2) and --diff_feat 1
    (two ReviewNets on encoders 0 and 1, greedy): identical predictions and
    equal metrics."""
    jopt, topt, jl, tl = _loaders(tmp_path)
    if mode == "diff_feat":
        members = _review_members(jopt, topt, 2)
    else:
        members = _fixture_members(jopt, topt)
    kw = dict(split="val", val_images_use=8, beam_size={"plain": 3, "flip": 2}.get(mode, 1),
              diff_feat=mode == "diff_feat", flip_ensemble=mode == "flip")
    jpreds, jstats = j_eval([(m[0], m[1]) for m in members], jl, jopt, **kw)
    tpreds, tstats = t_eval([(m[2], m[3]) for m in members], tl, topt, **kw)
    assert len(tpreds) == 8 and tpreds == jpreds
    assert sorted(tstats) == sorted(jstats)
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-12, atol=1e-12, err_msg=k)
    if mode == "flip":  # the flipped features are those of the same images
        plain, _ = t_eval([(m[2], m[3]) for m in members], tl, topt, **dict(
            kw, flip_ensemble=False, language_eval_flag=False))
        assert [p["image_id"] for p in plain] == [p["image_id"] for p in tpreds]


def test_bf16_members_decode_sanely(tmp_path):
    """--dtype bfloat16 casts the members (score math stays f32): most
    captions of a two-member ensemble equal the f32 ones."""
    jopt, topt, _, tl = _loaders(tmp_path)
    members = [(m[2], m[3]) for m in _fixture_members(jopt, topt)]
    kw = dict(split="val", beam_size=2, val_images_use=8, language_eval_flag=False)
    f32, _ = t_eval(members, tl, topt, **kw)
    topt.dtype = "bfloat16"
    bf16, _ = t_eval(members, tl, topt, **kw)
    assert len(bf16) == len(f32) == 8
    assert all(p["caption"] for p in bf16)
    assert sum(a["caption"] == b["caption"] for a, b in zip(f32, bf16)) >= 4
    assert members[0][1]["embed"].dtype == torch.float32  # the caller's trees stay f32


def _jax_cli():
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("jax_eval_ensemble_cli",
                                                  os.path.join(REPO, "eval_ensemble.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def test_port_cli_over_jax_triples_gives_the_jax_clis_predictions(tmp_path, monkeypatch,
                                                                   capsys):
    """Two JAX-written ReviewNet triples of one id (ranks 0 and 1, tied and
    untied keys): the port CLI with --n_ranks 2 and with the id:rank list
    prints the JAX CLI's metrics and returns its predictions."""
    from recurrent_fusion_network_tpu.data.synthetic import synthetic_dataset

    jopt, _ = single_options("review_net")
    ds = synthetic_dataset(seed=jopt.seed, correlated=True)  # what both CLIs load
    jopt.vocab_size, jopt.seq_length, jopt.id = ds.vocab_size, ds.seq_length, "ens"
    for rank, tied in enumerate((1, 0)):
        jopt.tied_att_keys = tied
        jm = j_model(jopt)
        params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(rank)))
        j_ckpt.save_checkpoint(str(tmp_path), "ens", rank, params=params, best=True,
                               infos={"iter": 1, "opt": dict(vars(jopt))})
    flags = ["--model_path", str(tmp_path), "--beam_size", "2", "--batch_size", "4",
             "--seq_per_img", "2", "--val_images_use", "8", "--eval_split", "val",
             "--synthetic_features", "1"]
    cli, got = _jax_cli(), {}
    real = cli.eval_ensemble

    def record(*a, **kw):
        got["out"] = real(*a, **kw)
        return got["out"]

    monkeypatch.setattr(cli, "eval_ensemble", record)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["eval_ensemble.py", "--model_ids", "ens", "--n_ranks", "2"]
                        + flags)
    cli.main()
    jax_printed = capsys.readouterr().out
    jpreds, jstats = got["out"]
    for ids in (["--model_ids", "ens", "--n_ranks", "2"], ["--model_ids", "ens:0,ens:1"]):
        tpreds, tstats = t_cli.main(ids + flags + ["--device", "cpu"])
        assert tpreds == jpreds and len(tpreds) == 8
        assert capsys.readouterr().out == jax_printed
    with pytest.raises(SystemExit, match="SINGLE"):
        t_cli.main(["--model_ids", "ens:1", "--n_ranks", "2"] + flags + ["--device", "cpu"])
