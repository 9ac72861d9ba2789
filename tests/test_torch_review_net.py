"""The port's ReviewNet model vs the JAX package's, f32 on the CPU at tiny
widths, in four profiles: tied keys (the default), untied keys
(--reference_parity), the Mixture-of-Softmax head (--use_mos) and maxout
in the review cells and the decoder. The review cell, the MoS head and the
single-head criterion; encode / forward with the reason head, greedy and
beam-3 tokens, the XE and SCST steps, checkpoint triples both ways, the
three CLIs and the HTTP front end. Tolerances are those of
tests/_single_encoder_parity.py (outputs rtol 1e-4 / atol 1e-5, tokens
identical, step losses rtol 1e-5, grads rtol 2e-3 / atol 2e-5); the bf16
MoS head is held to rtol 2e-2 / atol 2e-2 (probabilities) and atol 5e-2
(log-probabilities), a few bf16 ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.models import setup as t_model
from recurrent_fusion_network_torch.ops import cells as t_cells
from recurrent_fusion_network_torch.ops import losses as t_losses
from recurrent_fusion_network_torch.ops import mos as t_mos
from recurrent_fusion_network_torch.training.checkpoint import cast_tree
from recurrent_fusion_network_tpu.models import setup as j_model
from recurrent_fusion_network_tpu.ops import cells as j_cells
from recurrent_fusion_network_tpu.ops import losses as j_losses
from recurrent_fusion_network_tpu.ops import mos as j_mos

import _single_encoder_parity as parity
from test_torch_train import _close, _loss_inputs, _np_tree, _t

torch.set_num_threads(1)
PROFILES = {
    "tied": {},
    "untied": dict(reference_parity=1),
    "mos": dict(use_mos=1, num_expert=3),
    "maxout": dict(review_maxout=1, maxout=1),
}


def _pair(profile):
    return parity.options("review_net", **PROFILES[profile])


# ------------------------------------------------------------ cells, heads


@pytest.mark.parametrize("maxout", [False, True])
def test_no_input_lstm_step_matches_jax(maxout):
    g = np.random.default_rng(0)
    B, R, A, D, H = 3, 8, 5, 6, 7
    jp = _np_tree(j_cells.no_input_lstm_init(jax.random.PRNGKey(1), R, D, H, maxout=maxout))
    jp["att"] = jax.tree_util.tree_map(lambda x: x + g.standard_normal(x.shape).astype(
        np.float32) * 0.1, jp["att"])  # the zero fills would hide the biases
    att = g.standard_normal((B, A, D)).astype(np.float32)
    h, c = (g.standard_normal((B, R)).astype(np.float32) for _ in range(2))
    keys = g.standard_normal((B, A, H)).astype(np.float32)
    for k in (None, keys):
        jout, (jh, jc) = j_cells.no_input_lstm_step(jp, att, (h, c), keys=k, rnn_size=R,
                                                    maxout=maxout)
        tout, (th, tc) = t_cells.no_input_lstm_step(
            params_from_jax(jp), _t(att), (_t(h), _t(c)),
            keys=None if k is None else _t(k), rnn_size=R, maxout=maxout)
        for a, b in ((tout, jout), (th, jh), (tc, jc)):
            _close(a, b)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_init_layout_and_fills(profile):
    """The port's init has the JAX tree (keys and shapes, review cells
    stacked on the step axis, MoS latents on E); the review cells' biases
    are filled with 0.0 (attention) and -1.0 (h2h, z2h). The two packages'
    random streams differ, so fills and bounds are held, not values."""
    jopt, topt = _pair(profile)
    jm, tm = j_model(jopt), t_model(topt)
    jp = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(tp)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(tp)):
        assert a.shape == tuple(b.shape), path
    review = tp["review"]
    S = tm.num_review_steps
    assert all(x.shape[0] == S for x in jax.tree_util.tree_leaves(review))
    for name in ("h_2_att_h", "att_h_2_out") + (() if tm.tied_att_keys else ("att_2_att_h",)):
        assert (review["att"][name]["b"] == 0.0).all(), name
    for name in ("h2h", "z2h"):
        assert (review[name]["b"] == -1.0).all(), name
    assert ("review_keys" in tp) == tm.tied_att_keys
    if tm.tied_att_keys:
        assert (tp["review_keys"]["b"] == 0.0).all()
    assert ("mos" in tp) == tm.use_mos and "logit" in tp
    if tm.use_mos:
        assert tp["mos"]["latent"]["w"].shape[0] == tm.num_expert
        assert "b" not in tp["mos"]["prior"]


def _mos_case(seed=0, B=4, R=8, M=6, E=3, V=11):
    g = np.random.default_rng(seed)
    jp = _np_tree(j_mos.init(jax.random.PRNGKey(seed), R, M, E, V))
    return jp, g.standard_normal((B, R)).astype(np.float32)


def test_mos_apply_and_log_apply_match_jax_in_f32():
    jp, out = _mos_case()
    tp = params_from_jax(jp)
    probs = t_mos.apply(tp, _t(out))
    _close(probs, j_mos.apply(jp, out))
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    _close(t_mos.log_apply(tp, _t(out)), j_mos.log_apply(jp, out))


def test_mos_apply_and_log_apply_match_jax_in_bf16():
    """Both heads compute in the parameters' dtype and take the log in f32."""
    jp, out = _mos_case(seed=1)
    jp16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), jp)
    tp16 = cast_tree(params_from_jax(jp), torch.bfloat16)
    out16 = jnp.asarray(out, jnp.bfloat16)
    jprobs, jlog = j_mos.apply(jp16, out16), j_mos.log_apply(jp16, out16)
    tprobs = t_mos.apply(tp16, _t(out).to(torch.bfloat16))
    tlog = t_mos.log_apply(tp16, _t(out).to(torch.bfloat16))
    assert tprobs.dtype == torch.bfloat16 and str(jprobs.dtype) == "bfloat16"
    assert tlog.dtype == torch.float32 and str(jlog.dtype) == "float32"
    _close(tprobs.float(), np.asarray(jprobs, np.float32), rtol=2e-2, atol=2e-2)
    _close(tlog, jlog, rtol=0, atol=5e-2)


@pytest.mark.parametrize("smoothing", [False, True])
def test_review_net_loss_matches_jax(smoothing):
    lp, target, mask, heads, top = _loss_inputs()
    kw = dict(use_label_smoothing=smoothing, label_smoothing_epsilon=0.1, max_targets=5)
    _close(t_losses.review_net_loss(_t(lp), _t(target), _t(mask), _t(heads[0]), _t(top),
                                    0.3, **kw),
           j_losses.review_net_loss(lp, target, mask, heads[0], top, 0.3, **kw))


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_encode_forward_and_reason_head_match_jax(profile):
    parity.check_forward(*parity.models(*_pair(profile)))


@pytest.mark.parametrize("beam_size", [1, 3])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_greedy_and_beam_tokens_match_jax(profile, beam_size):
    parity.check_tokens(*parity.models(*_pair(profile)), beam_size)


def test_mos_decode_logits_are_the_mixture_probabilities():
    """The ensemble hook: under use_mos decode_logits returns the mixture's
    probabilities, as the JAX package's does."""
    jm, tm, jp, tp = parity.models(*_pair("mos"))
    fc, att, labels, _, _ = parity.batch()
    jenc, tenc = jm.encode(jp, fc, att), tm.encode(tp, _t(fc), _t(att))
    jp1, _ = jm.decode_logits(jp, jm.embed(jp, labels[:, 1]), jenc.memory, jenc.state)
    tp1, _ = tm.decode_logits(tp, tm.embed(tp, _t(labels[:, 1])), tenc.memory, tenc.state)
    _close(tp1, jp1)
    np.testing.assert_allclose(tp1.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_xe_step_matches_jax(profile):
    parity.check_xe_step(*_pair(profile), min_leaves=20)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_scst_step_matches_jax(profile):
    parity.check_rl_step(*_pair(profile), min_leaves=20)


def test_rollout_greedy_half_matches_jax():
    parity.check_rollout_greedy(*_pair("tied"))


def test_remat_and_low_rank_ctx_are_refused():
    """use_remat (once refused) gives forward's log-probs and reason head
    bit for bit under both policies; low_rank_ctx is refused."""
    jopt, topt = _pair("tied")
    _, tm, _, tp = parity.models(jopt, topt)
    fc, att, labels, _, _ = parity.batch()
    from dataclasses import replace

    want = tm.forward(tp, _t(fc), _t(att), _t(labels))
    for policy in ("save_ctx", "full"):
        got = replace(tm, use_remat=True, remat_policy=policy).forward(
            tp, _t(fc), _t(att), _t(labels))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1][0], want[1][0])
    topt.low_rank_ctx = 1
    with pytest.raises(ValueError, match="low_rank_ctx"):
        type(tm).from_opt(topt)


# ------------------------------------------------- checkpoints, CLIs, HTTP


@pytest.mark.parametrize("profile", ["tied", "mos"])
def test_checkpoints_load_both_ways(tmp_path, profile):
    parity.check_checkpoints_both_ways(tmp_path, *_pair(profile))


def test_main_eval_main_rl_on_the_cpu(tmp_path, capsys):
    parity.check_clis(tmp_path, capsys, "review_net", "--use_mos", "1", "--num_expert", "2")


def test_http_front_end_answers_caption(tmp_path):
    jopt, _ = _pair("tied")
    svc = parity.check_http(tmp_path, jopt, (parity.A, parity.ATT))
    assert svc.single and svc.server.feat_dims == ((parity.FC,), (parity.ATT,))
