"""Parity checks shared by tests/test_torch_show_tell.py and
tests/test_torch_review_net.py: the single-encoder models of the port
against the JAX package's, f32 on the CPU at tiny widths.

Weights come from the JAX init through ``params_from_jax``, inputs from a
numpy seed; both packages run at dropout 0 and ss_prob 0 (their random
streams cannot be matched). The JAX models take bare arrays; the port's
drivers hand every model per-encoder lists, and the checks drive the port
both ways. Tolerances, those of test_torch_train.py and test_torch_rl.py:
  * outputs (log-probs, states, reason heads): rtol 1e-4 / atol 1e-5;
  * greedy and beam-3 tokens: identical;
  * the XE / SCST step: loss rtol 1e-5, every grad leaf rtol 2e-3 / atol
    2e-5, params and Adam moments after 3 steps rtol 1e-4 / atol 1e-5
    (the score biases att_h_2_out.b, whose true gradient is 0, atol only).
The JAX side of a step is its value_and_grad, optax chain and
apply_updates, the parts of the JAX make_train_step / make_rl_step, which
test_torch_train.py and test_torch_rl.py hold whole against the port.
"""

import http.client
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from recurrent_fusion_network_torch import config as t_config
from recurrent_fusion_network_torch import eval as t_eval_cli
from recurrent_fusion_network_torch import main as t_main
from recurrent_fusion_network_torch import main_rl as t_main_rl
from recurrent_fusion_network_torch import serve as t_serve
from recurrent_fusion_network_torch.convert import check_params, params_from_jax
from recurrent_fusion_network_torch.decoding.api import model_sample as t_sample
from recurrent_fusion_network_torch.decoding.http_serve import run_server
from recurrent_fusion_network_torch.models import setup as t_model
from recurrent_fusion_network_torch.ops.initializers import tree_map
from recurrent_fusion_network_torch.training import checkpoint as t_ckpt
from recurrent_fusion_network_torch.training import optim as t_optim
from recurrent_fusion_network_torch.training import train_rl_loop as t_rl
from recurrent_fusion_network_torch.training.criterion import make_criterion as t_crit
from recurrent_fusion_network_torch.training.criterion import make_rl_criterion as t_rl_crit
from recurrent_fusion_network_torch.training.optim import AdamState
from recurrent_fusion_network_torch.training.train_loop import make_train_step as t_step
from recurrent_fusion_network_torch.training.train_loop import save_triple, snapshot_opt
from recurrent_fusion_network_tpu.config import Options as JaxOptions
from recurrent_fusion_network_tpu.decoding.api import model_sample as j_sample
from recurrent_fusion_network_tpu.models import setup as j_model
from recurrent_fusion_network_tpu.training import checkpoint as j_ckpt
from recurrent_fusion_network_tpu.training import optim as j_optim
from recurrent_fusion_network_tpu.training.criterion import make_criterion as j_crit
from recurrent_fusion_network_tpu.training.criterion import make_rl_criterion as j_rl_crit

from test_torch_train import _close, _GradSpy, _is_score_bias, _np_tree, _pairs, _t

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
LOSS_RTOL = 1e-5
LR = 5e-4
V, L, FC, ATT, A, W = 30, 5, 12, 10, 5, 12  # vocab, length, widths, top words


def options(caption_model, **over):
    """(JAX opt, port opt) of one tiny single-encoder model; tied_att_keys
    resolved by the JAX Options and copied to the port's."""
    kw = dict(caption_model=caption_model,
              feat_array_info=[{"fc_feat_size": FC, "att_feat_size": ATT, "att_num": A}],
              rnn_size=16, input_encoding_size=16, att_hid_size=16, num_review_steps=3,
              top_words_count=W, use_label_smoothing=1, reason_weight=0.7, **over)
    jopt = JaxOptions(feature_type="synthetic", **kw)
    topt = t_config.Options(**kw)
    topt.tied_att_keys = jopt.tied_att_keys
    for o in (jopt, topt):
        o.vocab_size, o.seq_length = V, L
    return jopt, topt


def models(jopt, topt, seed=0):
    """(JAX model, port model, JAX params as numpy, port params)."""
    jm, tm = j_model(jopt), t_model(topt)
    jp = _np_tree(jm.init_params(jax.random.PRNGKey(seed)))
    tp = params_from_jax(jp)
    check_params(tm, tp)
    return jm, tm, jp, tp


def batch(seed=1, B=4):
    """fc (B, FC), att (B, A, ATT), labels / masks (B, L+2) with padded rows,
    top words (B, W) with a row of more than max_targets."""
    g = np.random.default_rng(seed)
    fc = g.standard_normal((B, FC)).astype(np.float32)
    att = g.standard_normal((B, A, ATT)).astype(np.float32)
    labels = np.zeros((B, L + 2), np.int64)
    for r in range(B):
        n = int(g.integers(2, L + 1))
        labels[r, 1:n + 1] = g.integers(1, V + 1, n)
    masks = np.zeros((B, L + 2), np.float32)
    for r in range(B):
        masks[r, : int((labels[r] != 0).sum()) + 2] = 1.0
    top = np.full((B, W), -1, np.int64)
    top[:, :3] = g.integers(0, W, (B, 3))
    top[0, :] = np.arange(W)
    return fc, att, labels, masks, top


def rl_batch(seed=7, B=4):
    """An injected sampled sequence (rows ending early, one empty) and its
    per-row reward."""
    g = np.random.default_rng(seed)
    seq = g.integers(1, V + 1, (B, L))
    seq[0, 2:] = 0
    seq[1, 0:] = 0
    seq[2, 4:] = 0
    reward = np.repeat(g.normal(0, 1, (B, 1)), L, axis=1).astype(np.float32)
    return seq, reward


# ------------------------------------------------------------------ model


def check_forward(jm, tm, jp, tp):
    """encode's state and memory, the reason heads and forward's log-probs,
    the port driven with bare tensors and with one-element lists."""
    fc, att, labels, _, _ = batch()
    jenc = jm.encode(jp, fc, att)
    jlps, jreason = jm.forward(jp, fc, att, labels)
    for style in (lambda x: _t(x), lambda x: [_t(x)]):
        tenc = tm.encode(tp, style(fc), style(att))
        for a, b in zip(jax.tree_util.tree_leaves(jenc.state),
                        jax.tree_util.tree_leaves(tenc.state)):
            _close(b, a)
        if jenc.memory is None:
            assert tenc.memory is None
        else:
            _close(tenc.memory["thoughts"], jenc.memory["thoughts"])
            _close(tenc.memory["keys"], jenc.memory["keys"])
        xt = tm.embed(tp, _t(labels[:, 1]))
        jl1, _ = jm.decode_logprobs(jp, jm.embed(jp, labels[:, 1]), jenc.memory, jenc.state)
        tl1, _ = tm.decode_logprobs(tp, xt, tenc.memory, tenc.state)
        _close(tl1, jl1)
        tlps, treason = tm.forward(tp, style(fc), style(att), _t(labels))
        assert tlps.dtype == torch.float32 and tlps.shape == (4, L + 1, V + 1)
        _close(tlps, jlps)
        assert len(treason) == len(jreason)
        for a, b in zip(treason, jreason):
            _close(a, b)


def check_tokens(jm, tm, jp, tp, beam_size):
    """Greedy (beam 1) or beam-3 tokens identical, log-probs within
    tolerance, through decoding/api.py with bare arrays on both sides."""
    fc, att, _, _, _ = batch(seed=2, B=5)
    jout = jax.jit(lambda p, f, a: j_sample(jm, p, f, a, beam_size=beam_size))(jp, fc, att)
    with torch.no_grad():
        tout = t_sample(tm, tp, _t(fc), _t(att), beam_size=beam_size)
    np.testing.assert_array_equal(tout.seq.numpy(), np.asarray(jout.seq))
    _close(tout.seq_logprobs, jout.seq_logprobs)
    if beam_size > 1:
        np.testing.assert_array_equal(tout.top_seq.numpy(), np.asarray(jout.top_seq))
        _close(tout.top_p, jout.top_p)
    else:
        _close(tout.logprobs_all, jout.logprobs_all)
    assert len(tout.reason_preds) == len(jout.reason_preds)
    for a, b in zip(tout.reason_preds, jout.reason_preds):
        _close(a, b)


def _jax_steps(jloss, jtx, jp):
    """The JAX package's step, as make_train_step / make_rl_step take it:
    jax.value_and_grad of the loss, the optax chain's update, then
    apply_updates at LR, 3 times. -> (first loss, first grads, params and
    optimizer state after 3 steps)."""
    value_and_grad = jax.jit(jax.value_and_grad(jloss))
    params, state = jax.tree_util.tree_map(jnp.array, jp), jtx.init(jp)
    for i in range(3):
        loss, grads = value_and_grad(params)
        if i == 0:
            first = (loss, grads)
        direction, state = jtx.update(grads, state, params)
        params = j_optim.apply_updates(params, direction, LR)
    return first[0], first[1], params, state


def _check_update(jg, spy_grads, jparams, jstate, tp, state, min_leaves):
    n = 0
    for path, gj, gt in _pairs(_np_tree(jg), spy_grads):
        _close(gt, gj, rtol=0 if _is_score_bias(path) else GRAD_RTOL, atol=GRAD_ATOL,
               msg=f"grad {path}")
        n += 1
    assert n >= min_leaves
    for path, pj, pt in _pairs(_np_tree(jparams), tp):
        _close(pt, pj, rtol=0 if _is_score_bias(path) else RTOL,
               atol=LR * 3 if _is_score_bias(path) else ATOL, msg=f"param {path}")
    adam = _np_tree(jstate[-1])
    assert state.count == int(adam.count) == 3
    for name in ("mu", "nu"):
        for path, mj, mt in _pairs(getattr(adam, name), getattr(state, name)):
            _close(mt, mj, msg=f"{name} {path}")


def check_xe_step(jopt, topt, min_leaves):
    """Loss and every grad leaf of the first XE step, then params and Adam
    moments after 3 steps (weight decay and the clamp on)."""
    jopt.grad_clip = topt.grad_clip = 0.05
    jm, tm, jp, tp = models(jopt, topt)
    fc, att, labels, masks, top = batch()
    jc = j_crit(jopt)

    def jloss(p):
        lps, reason = jm.forward(p, fc, att, labels, deterministic=False)
        return jc(lps, labels, masks, reason, top)

    jl, jg, jparams, jstate = _jax_steps(jloss, j_optim.make_optimizer(jopt), jp)

    spy = _GradSpy(t_optim.make_optimizer(topt))
    step = t_step(tm, t_crit(topt), spy)
    state = spy.init(tp)
    args = ([_t(fc)], [_t(att)], _t(labels), _t(masks), _t(top))  # as device_batch gives
    losses = []
    for _ in range(3):
        tp, state, loss = step(tp, state, *args, LR, 0.0, None)
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], float(jl), rtol=LOSS_RTOL)
    assert losses[2] < losses[0]
    _check_update(jg, spy.grads, jparams, jstate, tp, state, min_leaves)


def check_rl_step(jopt, topt, min_leaves):
    """The SCST step on an injected sampled sequence and reward: loss and
    every grad leaf of the first step, params and Adam moments after 3."""
    for o in (jopt, topt):
        o.grad_clip, o.entropy_reg = 0.05, 0.05
    jm, tm, jp, tp = models(jopt, topt)
    fc, att, _, _, top = batch()
    seq, reward = rl_batch()
    old = np.zeros_like(reward)
    jc, jtx = j_rl_crit(jopt), j_optim.make_optimizer(jopt)

    def jloss(p):
        lps, reason = jm.forward(p, fc, att, np.asarray(t_rl.seq_to_inputs(_t(seq))))
        slp = jnp.take_along_axis(lps[:, :seq.shape[1]], seq[..., None], axis=2)[..., 0]
        return jc(slp, seq, reward, lps, reason, top, old)

    jl, jg, jparams, jstate = _jax_steps(jloss, jtx, jp)

    spy = _GradSpy(t_optim.make_optimizer(topt))
    step, _ = t_rl.make_rl_step(tm, t_rl_crit(topt), spy)
    state = spy.init(tp)
    losses = []
    for _ in range(3):
        tp, state, loss = step(tp, state, [_t(fc)], [_t(att)], _t(seq), _t(reward), _t(top),
                               LR, _t(old))
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], float(jl), rtol=LOSS_RTOL)
    _check_update(jg, spy.grads, jparams, jstate, tp, state, min_leaves)


def check_rollout_greedy(jopt, topt):
    """The rollout's greedy half equals the JAX greedy decode; its sampled
    half is a valid sequence (0 after the first 0)."""
    jm, tm, jp, tp = models(jopt, topt)
    fc, att, _, _, _ = batch(seed=3, B=5)
    seq, greedy = t_rl.make_rollout_fn(tm)(tp, [_t(fc)], [_t(att)],
                                           torch.Generator().manual_seed(0))
    jout = jax.jit(lambda p, f, a: j_sample(jm, p, f, a, beam_size=1).seq)(jp, fc, att)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jout))
    ended = np.cumsum(seq.numpy() == 0, axis=1) > 0
    assert (seq.numpy()[ended] == 0).all()


# ------------------------------------------------------------ checkpoints


def check_checkpoints_both_ways(tmp_path, jopt, topt):
    """A port-written triple loads in the JAX package (its arch check
    passes, its model decodes the port's beam-3 tokens); a JAX-written
    triple loads in the port (layout and arch checks, the same tokens)."""
    jm, tm, jp, tp = models(jopt, topt, seed=3)
    fc, att, _, _, _ = batch(seed=4, B=3)
    with torch.no_grad():
        want = t_sample(tm, tp, [_t(fc)], [_t(att)], beam_size=3).seq.numpy()
    topt.checkpoint_path, topt.id = str(tmp_path / "port"), "p"
    state = AdamState(count=2, mu=tree_map(torch.zeros_like, tp),
                      nu=tree_map(torch.ones_like, tp))
    save_triple(topt, 0, tp, state, {"iter": 2, "opt": snapshot_opt(topt)}, best=True)
    params, opt_state, infos = j_ckpt.load_checkpoint(str(tmp_path / "port"), "p", 0)
    j_ckpt.assert_arch_matches(jopt, infos["opt"])
    assert opt_state[-1].count == 2
    beam = jax.jit(lambda p, f, a: j_sample(jm, p, f, a, beam_size=3).seq)
    np.testing.assert_array_equal(np.asarray(beam(params, fc, att)), want)

    j_ckpt.save_checkpoint(str(tmp_path / "jax"), "j", 0, params=jp,
                           infos={"iter": 0, "opt": dict(vars(jopt))}, best=True)
    params, infos = t_ckpt.load_checkpoint(str(tmp_path / "jax"), "j", 0)
    t_ckpt.assert_arch_matches(topt, infos["opt"])
    params = params_from_jax(params)
    check_params(tm, params)
    with torch.no_grad():
        got = t_sample(tm, params, [_t(fc)], [_t(att)], beam_size=3).seq.numpy()
    np.testing.assert_array_equal(got, np.asarray(beam(jp, fc, att)))


# ---------------------------------------------------------------- drivers


def tiny_flags(caption_model, *extra):
    return ["--device", "cpu", "--feature_type", "synthetic", "--caption_model",
            caption_model, "--rnn_size", "16", "--input_encoding_size", "16",
            "--att_hid_size", "16", "--num_review_steps", "2", "--batch_size", "4",
            "--seq_per_img", "2", "--losses_log_every", "1", *extra]


def check_clis(tmp_path, capsys, caption_model, *extra):
    """main (XE, a boundary at 2) -> eval of its best triple (beam 3) ->
    main_rl warm-started from it (a boundary at 4), on the CPU on the
    synthetic single-encoder data; the triples carry the model's name."""
    ck = str(tmp_path / "ck")
    common = tiny_flags(caption_model, *extra) + [
        "--checkpoint_path", ck, "--id", "cli", "--val_images_use", "8",
        "--eval_results_dir", str(tmp_path / "er")]
    info = t_main.main(common + ["--max_iterations", "3", "--save_checkpoint_every", "2"])
    assert info["iter"] == 3 and sorted(info["loss_history"]) == [0, 1, 2]
    _, saved = t_ckpt.load_checkpoint(ck, "cli", 0)
    assert saved["opt"]["caption_model"] == caption_model
    assert len(saved["opt"]["feat_array_info"]) == 1
    capsys.readouterr()
    loss, preds, stats = t_eval_cli.main([
        "--device", "cpu", "--model_path", ck, "--load_model_id", "cli", "--beam_size", "3",
        "--eval_results_dir", str(tmp_path / "er")])
    assert f"loss: {loss:.4f}" in capsys.readouterr().out and len(preds) == 8
    assert np.isfinite(loss) and all(np.isfinite(v) for v in stats.values())
    rl = t_main_rl.main(common + ["--max_iterations", "6", "--save_checkpoint_every", "2",
                                  "--start_from", ck, "--load_model_id", "cli",
                                  "--load_best_score", "0",
                                  "--cider_df", str(tmp_path / "missing.p")])
    assert rl["iter"] == 6 and sorted(rl["val_result_history"]) == [2, 4]
    assert os.path.exists(os.path.join(ck, "rl_model_cli_0-best.pkl"))
    assert all(np.isfinite(v) for v in rl["loss_history"].values())


# ---------------------------------------------------------------- serving


def check_http(tmp_path, jopt, att_shape):
    """A JAX-written triple of the model behind the port's serve path
    (build_service, warmup, the HTTP front end) on the CPU: /caption on an
    npz body answers 200 with the caption of the port's own beam-3 decode
    of the features, /healthz counts the request."""
    vocab = {str(i): f"w{i}" for i in range(1, V + 1)}
    jm = j_model(jopt)
    params = jm.init_params(jax.random.PRNGKey(5))
    j_ckpt.save_checkpoint(str(tmp_path), "sv", 0, params=params, opt_state=None,
                           infos={"opt": dict(vars(jopt)), "vocab": vocab}, best=True)
    svc = t_serve.build_service(t_config.parse_serve_opt([
        "--model_path", str(tmp_path), "--load_model_id", "sv", "--device", "cpu",
        "--serve_dtype", "float32", "--beam_size", "3", "--serve_batch_size", "2"]))
    svc.warmup()
    httpd = run_server(svc, "127.0.0.1", 0)
    try:
        g = np.random.default_rng(6)
        fc = g.standard_normal(FC).astype(np.float32)
        att = g.standard_normal(att_shape).astype(np.float32)
        buf = io.BytesIO()
        np.savez(buf, fc_0=fc, att_0=att)
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("POST", "/caption", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npz"})
        r = conn.getresponse()
        got = json.loads(r.read())
        assert r.status == 200, got
        with torch.no_grad():
            out = t_sample(svc.model, params_from_jax(_np_tree(params)), _t(fc[None]),
                           _t(att[None]), beam_size=3)
        want = svc.postprocess_row({"seq": out.seq[0].numpy(),
                                    "seq_logprobs": out.seq_logprobs[0].numpy()})
        assert got["caption"] == want["caption"] and got["caption"]
        np.testing.assert_allclose(got["logprob"], want["logprob"], rtol=RTOL, atol=ATOL)
        conn.request("POST", "/caption", body=b'{"fc": [[1.0]], "att": [[[1.0]]]}')
        r = conn.getresponse()
        assert r.status == 400, r.read()
        r.read()
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] and health["stats"]["requests"] == 1
        conn.close()
    finally:
        httpd.shutdown()
        svc.close()
        httpd.server_close()
    return svc
