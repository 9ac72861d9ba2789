"""The port's XE train step vs the JAX package's, f32 on the CPU, for the
tied-keys default, untied (--reference_parity) and low_rank_ctx profiles.

Weights come from the JAX init through params_from_jax, inputs from a numpy
seed, both packages at dropout 0 and ss_prob 0 (their random streams cannot
be matched; dropout and scheduled sampling are tested on their own
properties). Tolerances:
  * the additive-attention gradient and the losses: rtol 1e-4 / atol 1e-5;
  * the train step's loss rtol 1e-5, every grad leaf rtol 2e-3 / atol 2e-5
    (the tolerance of test_xe_step_torch_differential.py);
  * params and Adam moments after 3 steps rtol 1e-4 / atol 1e-5.
The score biases ``att_h_2_out.b`` are the exception: softmax is
shift-invariant, so their true gradient is 0 and both packages return
rounding noise, which Adam turns into steps of up to lr. Their grads are
held to atol 2e-5 alone and their params after n steps to atol lr * n.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.config import Options as TorchOptions
from recurrent_fusion_network_torch.convert import (check_params, opt_state_from_jax,
                                                    params_from_jax)
from recurrent_fusion_network_torch.kernels import additive_attention as aa
from recurrent_fusion_network_torch.models import RecurrentFusionModel as TorchRFNet
from recurrent_fusion_network_torch.models.base import xe_decode
from recurrent_fusion_network_torch.ops import attention as t_attention
from recurrent_fusion_network_torch.ops import cells as t_cells
from recurrent_fusion_network_torch.ops import losses as t_losses
from recurrent_fusion_network_torch.ops.initializers import tree_map
from recurrent_fusion_network_torch.training import optim as t_optim
from recurrent_fusion_network_torch.training.checkpoint import load_optimizer
from recurrent_fusion_network_torch.training.criterion import make_criterion as t_crit
from recurrent_fusion_network_torch.training.train_loop import make_train_step as t_step
from recurrent_fusion_network_torch.training.train_loop import train as t_train
from recurrent_fusion_network_tpu.config import Options as JaxOptions
from recurrent_fusion_network_tpu.models import RecurrentFusionModel as JaxRFNet
from recurrent_fusion_network_tpu.ops import attention as j_attention
from recurrent_fusion_network_tpu.ops import losses as j_losses
from recurrent_fusion_network_tpu.training import optim as j_optim
from recurrent_fusion_network_tpu.training.criterion import make_criterion as j_crit
from recurrent_fusion_network_tpu.training.train_loop import make_train_step as j_step

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
LR = 5e-4
TINY = dict(vocab_size=30, seq_length=5, fc_feat_sizes=(12, 14),
            att_feat_sizes=(16, 20), att_nums=(5, 6),
            input_encoding_size=16, rnn_size=16, att_hid_size=16,
            num_review_steps=2, num_review_steps_0=2, top_words_count=12)
PROFILES = {
    "tied": dict(tied_att_keys=True),
    "untied": dict(tied_att_keys=False),
    "low_rank_ctx": dict(tied_att_keys=True, low_rank_ctx=True),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _pairs(jtree, ttree, path=""):
    """(path, JAX leaf, port leaf) over the JAX tree's entries."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            yield from _pairs(jtree[k], ttree[k], f"{path}[{k!r}]")
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            yield from _pairs(a, b, f"{path}[{i}]")
    else:
        yield path, jtree, ttree


def _is_score_bias(path):
    return "'att_h_2_out']['b']" in path


# ----------------------------------------------------- attention gradient


def _attention_case(groups, masked, seed=0):
    rng = np.random.default_rng(seed)
    B, R, H, A, D = 4, 8, 8, 5, 6
    heads = [j_attention.init(k, R, D, H)
             for k in jax.random.split(jax.random.PRNGKey(seed), groups)]
    h = rng.standard_normal((B, R)).astype(np.float32)
    feats = rng.standard_normal((groups, B, A, D)).astype(np.float32)
    keys = rng.standard_normal((groups, B, A, H)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((B, A)) > 0.4
        mask[0] = False  # a fully masked row
        mask[1, 0] = True
    cz = rng.standard_normal((groups, B, D)).astype(np.float32)
    cw = rng.standard_normal((groups, B, A)).astype(np.float32)
    return heads, h, feats, keys, mask, cz, cw


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("groups", [1, 3])
def test_attention_backward_matches_jax_grad(groups, masked):
    """The Function's backward (through attend / attend_heads) vs jax.grad
    of JAX attend (vmapped over the heads as stage II runs them)."""
    heads, h, feats, keys, mask, cz, cw = _attention_case(groups, masked)
    jp = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *heads)

    def jloss(p, h, feats, keys):
        z, w = jax.vmap(lambda pp, f, k: j_attention.attend(pp, h, f, keys=k, mask=mask)
                        )(p, feats, keys)
        return jnp.sum(z * cz) + jnp.sum(w * cw)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(jp, h, feats, keys)

    tp = params_from_jax(_np_tree(jp))  # att_2_att_h stays unused: keys are given
    live = {k: {n: x.requires_grad_() for n, x in tp[k].items()}
            for k in ("h_2_att_h", "att_h_2_out")}
    th, tf, tk = (_t(x).requires_grad_() for x in (h, feats, keys))
    tmask = None if mask is None else _t(mask)
    if groups == 1:
        one = {k: {n: x[0] for n, x in v.items()} for k, v in tp.items()}
        z, w = t_attention.attend(one, th, tf[0], keys=tk[0], mask=tmask)
        z, w = z[None], w[None]
    else:
        z, w = t_attention.attend_heads(tp, th, tf, keys_stack=tk, mask=tmask)
    ((z * _t(cz)).sum() + (w * _t(cw)).sum()).backward()

    jg_p, jg_h, jg_f, jg_k = jgrads
    jg_p = {k: v for k, v in _np_tree(jg_p).items() if k in live}
    for path, gj, gt in _pairs(jg_p, tree_map(lambda x: x.grad, live)):
        _close(gt, gj, rtol=0 if _is_score_bias(path) else RTOL,
               atol=GRAD_ATOL if _is_score_bias(path) else ATOL, msg=path)
    _close(th.grad, jg_h)
    _close(tf.grad, jg_f)
    _close(tk.grad, jg_k)


@pytest.mark.parametrize("with_dw", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("groups", [1, 3])
def test_bwd_ref_matches_autograd_of_the_plain_forward(groups, masked, with_dw):
    rng = np.random.default_rng(5)
    N, A, H, D = 4, 6, 8, 5
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q, keys, v, bv, values = r(groups * N, H), r(groups * N, A, H), r(groups, H), \
        r(groups), r(groups * N, A, D)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random((groups * N, A)) > 0.4)
        mask[1] = False
    dz, dw = r(groups * N, D), r(groups * N, A) if with_dw else None
    ins = [t.clone().requires_grad_() for t in (q, keys, v, bv, values)]
    z, w = aa.additive_attention_ref(*ins, mask)
    out = (z * dz).sum() + ((w * dw).sum() if with_dw else 0)
    want = torch.autograd.grad(out, ins)
    _, w0 = aa.additive_attention_ref(q, keys, v, bv, values, mask)
    dq, dkeys, dvalues, dv, dbv = aa.additive_attention_bwd_ref(
        dz, dw, q, keys, v, values, w0, mask)
    for got, ref in zip((dq, dkeys, dv, dbv, dvalues), want):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    no_dv = aa.additive_attention_bwd_ref(dz, dw, q, keys, v, values, w0, mask,
                                          need_dvalues=False)
    assert no_dv[2] is None


def test_function_plumbing(monkeypatch):
    """dvalues is asked for only when values need a grad; a discarded w
    gives a None incoming grad; a non-contiguous dz is made contiguous;
    outputs keep the input dtype."""
    calls = []
    real = aa.additive_attention_bwd

    def spy(dz, dw, *args, need_dvalues):
        calls.append((dz.is_contiguous(), dw is None, need_dvalues))
        return real(dz, dw, *args, need_dvalues=need_dvalues)

    monkeypatch.setattr(aa, "additive_attention_bwd", spy)
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    q, keys, v, bv = (r(6, 4).requires_grad_(), r(6, 3, 4).requires_grad_(),
                      r(1, 4).requires_grad_(), r(1).requires_grad_())
    values = r(6, 3, 5)  # an input: no grad wanted
    z, _ = aa.additive_attention(q, keys, v, bv, values)
    (z.t() * r(5, 6)).sum().backward()  # dz arrives transposed
    assert calls == [(True, True, False)]
    assert values.grad is None and q.grad is not None and bv.grad.dtype == torch.float32
    values.requires_grad_()
    z, w = aa.additive_attention(q, keys, v, bv, values)
    (z.sum() + w[:, 0].sum()).backward()
    assert calls[-1] == (True, False, True) and values.grad is not None
    qb, kb, vb, bb, xb = (t.detach().to(torch.bfloat16).requires_grad_()
                          for t in (q, keys, v, bv, values))
    z, _ = aa.additive_attention(qb, kb, vb, bb, xb)
    z.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (qb, kb, vb, bb, xb))


# ------------------------------------------------------------------ losses


def _loss_inputs(seed=0, B=4, T=6, V=11, C=9, K=9, n_valid=(2, 9, 0, 4)):
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(V), size=(B, T))).astype(np.float32)
    target = rng.integers(0, V, (B, T + 1))
    mask = (rng.random((B, T + 1)) > 0.3).astype(np.float32)
    heads = [rng.standard_normal((B, C)).astype(np.float32) for _ in range(3)]
    top = np.full((B, K), -1, np.int64)
    for b, n in enumerate(n_valid):
        top[b, :n] = rng.permutation(C)[:n]
    return lp, target, mask, heads, top


@pytest.mark.parametrize("smoothing", [False, True])
def test_losses_match_jax(smoothing):
    """Row 1 has 9 valid top-words, more than max_targets = 5: both packages
    cut the target axis there, which F.multilabel_margin_loss does not."""
    lp, target, mask, heads, top = _loss_inputs()
    kw = dict(use_label_smoothing=smoothing, label_smoothing_epsilon=0.1)
    _close(t_losses.language_model_loss(_t(lp), _t(target), _t(mask), **kw),
           j_losses.language_model_loss(lp, target, mask, **kw))
    for mt in (None, 5):
        got = t_losses.multilabel_margin_loss(_t(heads[0]), _t(top), max_targets=mt)
        _close(got, j_losses.multilabel_margin_loss(heads[0], top, max_targets=mt))
    lib = torch.nn.functional.multilabel_margin_loss(_t(heads[0]), _t(top))
    _close(t_losses.multilabel_margin_loss(_t(heads[0]), _t(top)), lib.numpy())
    cut = t_losses.multilabel_margin_loss(_t(heads[0]), _t(top), max_targets=5)
    assert abs(cut.item() - lib.item()) > 1e-3
    _close(t_losses.review_net_ensemble_loss(
        _t(lp), _t(target), _t(mask), [_t(x) for x in heads], _t(top), 0.3,
        max_targets=5, **kw),
        j_losses.review_net_ensemble_loss(lp, target, mask, heads, top, 0.3,
                                          max_targets=5, **kw))


# ------------------------------------------------------- model + train step


def _models(profile):
    kw = {**TINY, **PROFILES[profile]}
    jm = JaxRFNet(**kw)
    tm = TorchRFNet(**{f.name: kw[f.name] for f in dataclasses.fields(TorchRFNet)
                       if f.name in kw})
    return jm, tm, jm.init_params(jax.random.PRNGKey(0))


def _batch(seed=1, B=4):
    g = np.random.default_rng(seed)
    L = TINY["seq_length"]
    fcs = [g.standard_normal((B, d)).astype(np.float32) for d in TINY["fc_feat_sizes"]]
    atts = [g.standard_normal((B, n, d)).astype(np.float32)
            for n, d in zip(TINY["att_nums"], TINY["att_feat_sizes"])]
    labels = np.zeros((B, L + 2), np.int64)
    for r in range(B):
        n = int(g.integers(2, L + 1))  # rows shorter than L: real padding
        labels[r, 1:n + 1] = g.integers(1, TINY["vocab_size"] + 1, n)
    masks = np.zeros((B, L + 2), np.float32)
    for r in range(B):
        masks[r, : int((labels[r] != 0).sum()) + 2] = 1.0
    top = np.full((B, TINY["top_words_count"]), -1, np.int64)
    top[:, :3] = g.integers(0, TINY["top_words_count"], (B, 3))
    top[0, :] = np.arange(TINY["top_words_count"])  # more than max_targets
    return fcs, atts, labels, masks, top


def _opts(profile, **over):
    feats = [{"fc_feat_size": f, "att_feat_size": a, "att_num": n}
             for f, a, n in zip(TINY["fc_feat_sizes"], TINY["att_feat_sizes"],
                                TINY["att_nums"])]
    kw = dict(caption_model="recurrent_fusion_model", feat_array_info=feats,
              rnn_size=16, input_encoding_size=16, att_hid_size=16,
              num_review_steps=2, num_review_steps_0=2, top_words_count=12,
              tied_att_keys=int(PROFILES[profile]["tied_att_keys"]),
              low_rank_ctx=int(PROFILES[profile].get("low_rank_ctx", False)),
              use_label_smoothing=1, reason_weight=0.7, **over)
    jopt, topt = JaxOptions(feature_type="feat_array", **kw), TorchOptions(**kw)
    for o in (jopt, topt):
        o.vocab_size, o.seq_length = TINY["vocab_size"], TINY["seq_length"]
    return jopt, topt


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_forward_logprobs_match_jax(profile):
    jm, tm, jp = _models(profile)
    fcs, atts, labels, _, _ = _batch()
    jlps, jreason = jm.forward(jp, fcs, atts, labels)
    tlps, treason = tm.forward(params_from_jax(_np_tree(jp)), [_t(x) for x in fcs],
                               [_t(x) for x in atts], _t(labels))
    assert tlps.dtype == torch.float32
    assert tlps.shape == (4, TINY["seq_length"] + 1, TINY["vocab_size"] + 1)
    _close(tlps, jlps)
    assert len(treason) == len(jreason) == 3
    for a, b in zip(treason, jreason):
        _close(a, b)


class _GradSpy:
    """Wraps the port's optimizer and keeps a copy of the first step's grads."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        if self.grads is None:
            self.grads = tree_map(torch.clone, grads)
        return self.tx.update(grads, state, params)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_train_step_matches_jax(profile):
    """Loss and every grad leaf of the first step, then params and Adam
    moments after 3 steps (weight decay and clamp on)."""
    jm, tm, jp = _models(profile)
    jopt, topt = _opts(profile, grad_clip=0.05)
    fcs, atts, labels, masks, top = _batch()
    jcrit = j_crit(jopt)

    def jloss(p):
        lps, reason = jm.forward(p, fcs, atts, labels, deterministic=False)
        return jcrit(lps, labels, masks, reason, top)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    jtx = j_optim.make_optimizer(jopt)
    jstep = j_step(jm, jcrit, jtx)
    jparams, jstate = jax.tree_util.tree_map(jnp.array, jp), jtx.init(jp)
    for i in range(3):
        jparams, jstate, _ = jstep(jparams, jstate, fcs, atts, labels, masks, top, LR,
                                   0.0, jax.random.PRNGKey(i))

    tp = params_from_jax(_np_tree(jp))
    spy = _GradSpy(t_optim.make_optimizer(topt))
    step = t_step(tm, t_crit(topt), spy)
    state = spy.init(tp)
    batch = ([_t(x) for x in fcs], [_t(x) for x in atts], _t(labels), _t(masks), _t(top))
    losses = []
    for _ in range(3):
        tp, state, loss = step(tp, state, *batch, LR, 0.0, None)
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], float(jl), rtol=1e-5)
    assert losses[2] < losses[0]

    n = 0
    for path, gj, gt in _pairs(_np_tree(jg), spy.grads):
        score_bias = _is_score_bias(path)
        _close(gt, gj, rtol=0 if score_bias else GRAD_RTOL, atol=GRAD_ATOL,
               msg=f"grad {path}")
        n += 1
    assert n > 30
    for path, pj, pt in _pairs(_np_tree(jparams), tp):
        _close(pt, pj, rtol=0 if _is_score_bias(path) else RTOL,
               atol=LR * 3 if _is_score_bias(path) else ATOL, msg=f"param {path}")
    adam = _np_tree(jstate[-1])
    assert state.count == int(adam.count) == 3
    for name in ("mu", "nu"):
        for path, mj, mt in _pairs(getattr(adam, name), getattr(state, name)):
            _close(mt, mj, msg=f"{name} {path}")


def test_optimizer_sgd_and_schedules_match_jax():
    jopt, topt = _opts("tied", optim="sgd", optim_momentum=0.9, grad_clip=0.3,
                       learning_rate_decay_start=0, scheduled_sampling_start=0)
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), tree) for _ in range(3)]
    jtx, ttx = j_optim.make_optimizer(jopt), t_optim.make_optimizer(topt)
    jp, js = tree, jtx.init(tree)
    tp = params_from_jax(tree)
    ts = ttx.init(tp)
    for g in grads:
        d, js = jtx.update(g, js, jp)
        jp = j_optim.apply_updates(jp, d, 0.1)
        d, ts = ttx.update(params_from_jax(g), ts, tp)
        tp = t_optim.apply_updates(tp, d, 0.1)
    for path, a, b in _pairs(_np_tree(jp), tp):
        _close(b, a, msg=path)
    for epoch in range(12):
        assert t_optim.lr_for_epoch(topt, epoch, 0.1) == pytest.approx(
            j_optim.lr_for_epoch(jopt, epoch, 0.1))
        assert t_optim.ss_prob_for_epoch(topt, epoch) == pytest.approx(
            j_optim.ss_prob_for_epoch(jopt, epoch))
    for name in ("rmsprop", "adagrad", "adadelta"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_optim.make_optimizer(TorchOptions(optim=name))


# ------------------------------------------------------------- train loop


def _synthetic(profile="tied", **over):
    from recurrent_fusion_network_tpu.data.synthetic import synthetic_setup

    jopt, loader = synthetic_setup(
        tied_att_keys=int(PROFILES[profile]["tied_att_keys"]),
        low_rank_ctx=int(PROFILES[profile].get("low_rank_ctx", False)),
        losses_log_every=1, **over)
    topt = TorchOptions(**{k: getattr(jopt, k) for k in (
        "caption_model", "feat_array_info", "rnn_size", "input_encoding_size",
        "att_hid_size", "num_review_steps", "num_review_steps_0", "top_words_count",
        "tied_att_keys", "low_rank_ctx", "losses_log_every", "seed",
        "save_checkpoint_every")}, device="cpu")
    return jopt, topt, loader


def test_train_resumes_a_jax_checkpoint_on_the_jax_trajectory(tmp_path):
    """train() from a JAX-written checkpoint at iteration 0 gives the JAX
    train()'s loss history; from the triple the JAX run saved after 2 steps
    (params, optax state, loader state) it takes steps 2 and 3 to JAX's
    params. A checkpoint of another profile fails with the differing path."""
    from recurrent_fusion_network_tpu.models import setup as j_setup
    from recurrent_fusion_network_tpu.training import checkpoint as j_ckpt
    from recurrent_fusion_network_tpu.training.train_loop import train as j_train

    jopt, topt, loader = _synthetic()
    jm = j_setup(jopt)
    p0 = _np_tree(jm.init_params(jax.random.PRNGKey(7)))
    infos0 = {"iter": 0, "epoch": 0, "opt": dict(vars(jopt))}
    j_ckpt.save_checkpoint(str(tmp_path), "zero", 0, params=p0, infos=infos0)
    for o in (jopt, topt):
        o.start_from, o.load_model_id = str(tmp_path), "zero"
    jinfo = j_train(jopt, loader, max_iterations=3, log_fn=lambda *_: None)
    _, _, tloader = _synthetic()
    tinfo = t_train(topt, tloader, max_iterations=3, log_fn=lambda *_: None)
    assert sorted(tinfo["loss_history"]) == [0, 1, 2]
    np.testing.assert_allclose([tinfo["loss_history"][i] for i in range(3)],
                               [jinfo["loss_history"][i] for i in range(3)], rtol=1e-5)

    # the JAX run: 2 steps, a triple checkpoint, then 2 more steps
    jopt.start_from = None
    _, _, jl = _synthetic()
    crit, tx = j_crit(jopt), j_optim.make_optimizer(jopt)
    jstep = j_step(jm, crit, tx)
    params, state = jax.tree_util.tree_map(jnp.asarray, p0), tx.init(p0)
    for it in range(4):
        if it == 2:
            j_ckpt.save_checkpoint(
                str(tmp_path), "two", 0, params=params, opt_state=state,
                infos={"iter": 2, "epoch": 0, "opt": dict(vars(jopt)),
                       "iterators": dict(jl.iterators),
                       "split_image_id": {s: list(v) for s, v in jl.split_image_id.items()},
                       "loader_rng": dict(jl.rng_states)})
        d = jl.get_batch("train")
        params, state, _ = jstep(params, state, list(d["fc_feats_array"]),
                                 list(d["att_feats_array"]), d["labels"], d["masks"],
                                 d["top_words"], jopt.optim_lr, 0.0, jax.random.PRNGKey(it))
    _, topt2, tl = _synthetic()
    topt2.start_from, topt2.load_model_id = str(tmp_path), "two"
    tinfo = t_train(topt2, tl, max_iterations=4, log_fn=lambda *_: None)
    assert tinfo["iter"] == 4 and sorted(tinfo["loss_history"]) == [2, 3]
    assert tinfo["final_opt_state"].count == 4
    for path, a, b in _pairs(_np_tree(params), tinfo["final_params"]):
        _close(b, a, rtol=0 if _is_score_bias(path) else RTOL,
               atol=LR * 2 if _is_score_bias(path) else ATOL, msg=path)

    saved = load_optimizer(str(tmp_path), "two", 0, best=False)
    untied = _synthetic("untied")[1]
    untied.vocab_size, untied.seq_length = topt2.vocab_size, topt2.seq_length
    other = TorchRFNet.from_opt(untied)
    with pytest.raises(ValueError, match=r"^mu: expected keys .*review1_keys"):
        opt_state_from_jax(saved, other)
    check_params(TorchRFNet.from_opt(topt2), opt_state_from_jax(saved).nu, name="nu")


@pytest.mark.parametrize("name", ["show_tell", "review_net", "unknown"])
def test_criterion_takes_the_rfnet_model_only(name):
    """Every model's XE criterion equals the JAX package's (ShowTell: the
    XE alone; ReviewNet: plus its one reason head); an unknown model is a
    ValueError."""
    kw = dict(caption_model=name, use_label_smoothing=1, reason_weight=0.7, seq_length=3)
    if name == "unknown":
        with pytest.raises(ValueError, match="not supported"):
            t_crit(TorchOptions(**kw))
        return
    lp, target, mask, heads, top = _loss_inputs()
    labels = np.concatenate([np.zeros((4, 1), np.int64), target], 1)
    masks = np.concatenate([np.ones((4, 1), np.float32), mask], 1)
    want = j_crit(JaxOptions(feature_type="synthetic", **kw))(lp, labels, masks, heads[:1], top)
    got = t_crit(TorchOptions(**kw))(_t(lp), _t(labels), _t(masks), [_t(heads[0])], _t(top))
    _close(got, want)


def test_arch_check_resolves_auto_tied_keys():
    from recurrent_fusion_network_torch.training.checkpoint import assert_arch_matches

    saved = {"caption_model": "recurrent_fusion_model", "rnn_type": "lstm",
             "num_layers": 1, "use_mos": 0, "tied_att_keys": 1, "rnn_size": 512}
    rfnet = dict(caption_model="recurrent_fusion_model")
    assert_arch_matches(TorchOptions(tied_att_keys=-1, **rfnet), saved)
    with pytest.raises(ValueError, match="tied_att_keys"):
        assert_arch_matches(TorchOptions(tied_att_keys=-1, reference_parity=1, **rfnet), saved)
    with pytest.raises(ValueError, match="rnn_size"):
        assert_arch_matches(TorchOptions(tied_att_keys=1, rnn_size=16, **rfnet), saved)


def test_train_evaluates_and_writes_triples_at_boundaries_and_raises_for_remat(tmp_path):
    """train() evaluates at iterations 2 and 4 and writes the triple there;
    --use_remat raises."""
    _, topt, loader = _synthetic(save_checkpoint_every=2)
    topt.checkpoint_path, topt.id = str(tmp_path), "b"
    topt.eval_results_dir = str(tmp_path / "eval_results")
    infos = t_train(topt, loader, max_iterations=5, log_fn=lambda *_: None)
    assert infos["iter"] == 5 and sorted(infos["val_result_history"]) == [2, 4]
    assert os.path.exists(tmp_path / "model_b_0.pkl")
    _, topt, loader = _synthetic()
    topt.use_remat = 1
    with pytest.raises(NotImplementedError, match="remat"):
        t_train(topt, loader, max_iterations=1, log_fn=lambda *_: None)


def test_train_needs_cuda_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, topt, loader = _synthetic()
    topt.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train(topt, loader, max_iterations=1)


# --------------------------------------------- dropout, scheduled sampling


def test_maybe_dropout_properties():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(0)).abs() + 0.1
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    for rate, training in ((0.0, True), (0.5, False)):
        assert t_cells.maybe_dropout(x, rate, g, training) is x
    assert torch.equal(g.get_state(), state)  # nothing drawn
    y = t_cells.maybe_dropout(x.requires_grad_(), 0.25, g, True)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert 0.65 < kept.float().mean().item() < 0.85
    y.sum().backward()
    torch.testing.assert_close(x.grad, kept.float() / 0.75)
    again = t_cells.maybe_dropout(x.detach(), 0.25, torch.Generator().manual_seed(1), True)
    assert torch.equal(again != 0, kept)  # the generator alone decides the mask


def test_dropout_reaches_every_cell_in_training():
    _, tm, jp = _models("tied")
    tm = dataclasses.replace(tm, drop_prob_lm=0.5, drop_prob_reason=0.5,
                             drop_prob_fusion=0.5)
    p = params_from_jax(_np_tree(jp))
    fcs, atts, labels, _, _ = _batch()
    args = (p, [_t(x) for x in fcs], [_t(x) for x in atts], _t(labels))
    base, _ = tm.forward(*args)
    g = torch.Generator().manual_seed(0)
    a, _ = tm.forward(*args, generator=g, training=True)
    b, _ = tm.forward(*args, generator=torch.Generator().manual_seed(0), training=True)
    assert torch.equal(a, b) and not torch.allclose(a, base)
    counts = []
    for name in ("fusion", "reason", "lm"):
        one = dataclasses.replace(tm, **{f"drop_prob_{k}": 0.5 * (k == name)
                                         for k in ("fusion", "reason", "lm")})
        out, _ = one.forward(*args, generator=torch.Generator().manual_seed(0),
                             training=True)
        counts.append(not torch.allclose(out, base))
    assert all(counts)


def test_scheduled_sampling_properties():
    """ss_prob 0 draws nothing and is teacher forcing; ss_prob 1 feeds back
    the previous step's prediction from t = 1 on, t = 0 keeps BOS."""
    B, T, V = 5, 6, 7
    seq = torch.randint(1, V, (B, T), generator=torch.Generator().manual_seed(0))
    seq[:, 0] = 0
    seen = []

    def step(xt, state):
        seen.append(xt.clone())
        lp = torch.full((B, V), -1e4)
        lp[torch.arange(B), (xt + 1) % V] = 0.0  # next token is certain
        return lp, state

    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    xe_decode(step, lambda t: t, None, seq, ss_prob=0.0, generator=g)
    assert torch.equal(torch.stack(seen, 1), seq) and torch.equal(g.get_state(), state)
    seen.clear()
    xe_decode(step, lambda t: t, None, seq, ss_prob=1.0, generator=g)
    fed = torch.stack(seen, 1)
    assert torch.equal(fed[:, 0], seq[:, 0])
    assert torch.equal(fed[:, 1:], (fed[:, :-1] + 1) % V)
