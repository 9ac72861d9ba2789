"""Activation rematerialisation (``--use_remat``) in the port, f32 on the CPU.

The port's counterpart of the JAX package's
tests/test_models.py::test_remat_is_numerically_identical: with dropout on
and ss_prob 0.3, RFNet (tied keys, --reference_parity, --low_rank_ctx) and
ReviewNet (with and without the MoS head) give the same loss and gradients
with remat under both policies as without it, bit for bit (``torch.equal``),
and leave their generator in the same state. Against the JAX package with
use_remat=1 (dropout 0, ss_prob 0: the two random streams cannot be
matched) the gradients agree within rtol 1e-4 / atol 1e-5 (the score biases
att_h_2_out.b, whose true gradient is 0, within atol 1e-5 alone).
"""

import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.kernels import additive_attention as aa
from recurrent_fusion_network_torch.models import base as t_base
from recurrent_fusion_network_torch.models import setup as t_model
from recurrent_fusion_network_torch.ops.initializers import tree_leaves, tree_unflatten
from recurrent_fusion_network_torch.training.criterion import make_criterion as t_crit
from recurrent_fusion_network_tpu.models import setup as j_model
from recurrent_fusion_network_tpu.training.criterion import make_criterion as j_crit

import _single_encoder_parity as parity
from test_torch_train import _batch, _is_score_bias, _np_tree, _opts, _pairs, _t

torch.set_num_threads(1)
DROPOUT = dict(drop_prob_lm=0.5, drop_prob_reason=0.3, drop_prob_fusion=0.2)
CASES = {
    "rfnet_tied": ("recurrent_fusion_model", "tied"),
    "rfnet_reference_parity": ("recurrent_fusion_model", "untied"),
    "rfnet_low_rank_ctx": ("recurrent_fusion_model", "low_rank_ctx"),
    "review_net": ("review_net", {}),
    "review_net_mos": ("review_net", dict(use_mos=1, num_expert=3)),
}


def _case(name, **over):
    """(JAX opt, port opt, batch: fc list, att list, labels, masks, top)."""
    model, profile = CASES[name]
    if model == "recurrent_fusion_model":
        jopt, topt = _opts(profile, **over)
        fcs, atts, labels, masks, top = _batch()
    else:
        jopt, topt = parity.options("review_net", **profile, **over)
        fc, att, labels, masks, top = parity.batch()
        fcs, atts = [fc], [att]
    return jopt, topt, (fcs, atts, labels, masks, top)


def _params(jopt, topt):
    jm, tm = j_model(jopt), t_model(topt)
    jp = _np_tree(jm.init_params(jax.random.PRNGKey(0)))
    return jm, tm, jp


class _Counts:
    """Calls of the attention's plain versions (what runs on the CPU in
    place of the kernels): forward calls in the forward pass and in the
    backward (the recompute), and backward calls."""

    def __init__(self):
        self.fwd, self.bwd = 0, 0
        self._fwd, self._bwd = aa.additive_attention_ref, aa.additive_attention_bwd_ref

    def fwd_ref(self, *a, **k):
        self.fwd += 1
        return self._fwd(*a, **k)

    def bwd_ref(self, *a, **k):
        self.bwd += 1
        return self._bwd(*a, **k)

    def patch(self):
        return mock.patch.multiple(aa, additive_attention_ref=self.fwd_ref,
                                   additive_attention_bwd_ref=self.bwd_ref)


def _loss_and_grads(tm, topt, params, batch, ss_prob, generator, training):
    """-> (loss, grads, (forward calls in the forward, forward calls in
    the backward, backward calls)) of the XE criterion."""
    fcs, atts, labels, masks, top = batch
    leaves = [x.clone().requires_grad_() for x in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    counts = _Counts()
    with counts.patch():
        lps, reason = tm.forward(p, [_t(x) for x in fcs], [_t(x) for x in atts], _t(labels),
                                 ss_prob=ss_prob, generator=generator, training=training)
        loss = t_crit(topt)(lps, _t(labels), _t(masks), reason, _t(top))
        in_forward = counts.fwd
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss, tree_unflatten(params, list(grads)), (in_forward, counts.fwd - in_forward,
                                                       counts.bwd)


@pytest.mark.parametrize("policy", ["full", "save_ctx"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_equals_no_remat_bitwise_with_dropout_and_scheduled_sampling(case, policy):
    """Loss and every gradient leaf torch.equal with and without remat,
    dropout on and ss_prob 0.3, the generator left in the same state; the
    recompute runs every attention forward again under "full" and none
    under "save_ctx", and the backward calls do not change."""
    jopt, topt, batch = _case(case, **DROPOUT)
    _, tm, jp = _params(jopt, topt)
    assert not tm.use_remat and tm.drop_prob_lm == 0.5
    params = tree_unflatten(jp, [_t(x).clone() for x in tree_leaves(jp)])
    runs = {}
    for remat in (False, True):
        model = dataclasses.replace(tm, use_remat=remat, remat_policy=policy)
        g = torch.Generator().manual_seed(5)
        loss, grads, counts = _loss_and_grads(model, topt, params, batch, 0.3, g, True)
        runs[remat] = (loss, grads, counts, g.get_state())
    (l0, g0, c0, s0), (l1, g1, c1, s1) = runs[False], runs[True]
    assert torch.equal(l0, l1), (l0.item(), l1.item())
    n = 0
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
        n += 1
    assert n >= 20 and sum(bool((a != 0).any()) for a in tree_leaves(g0)) >= 0.8 * n
    assert torch.equal(s0, s1)
    fwd, recomputed, bwd = c1
    assert c0[1] == 0 and fwd == c0[0] and bwd == c0[2] == fwd
    assert recomputed == (fwd if policy == "full" else 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_gradients_match_the_jax_packages_use_remat(case):
    """Gradients of the XE criterion with remat ("save_ctx", the default)
    against the JAX package's with use_remat=1, dropout 0 and ss_prob 0."""
    jopt, topt, batch = _case(case, use_remat=1)
    jm, tm, jp = _params(jopt, topt)
    assert tm.use_remat and jm.use_remat and tm.remat_policy == jm.remat_policy == "save_ctx"
    fcs, atts, labels, masks, top = batch
    jc = j_crit(jopt)
    single = tm.__class__.__name__ == "ReviewNetModel"
    jfc, jatt = (fcs[0], atts[0]) if single else (fcs, atts)

    def jloss(p):
        lps, reason = jm.forward(p, jfc, jatt, labels, deterministic=False)
        return jc(lps, labels, masks, reason, top)

    jl, jg = jax.value_and_grad(jloss)(jp)
    params = tree_unflatten(jp, [_t(x).clone() for x in tree_leaves(jp)])
    loss, grads, _ = _loss_and_grads(tm, topt, params, batch, 0.0, None, False)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    n = 0
    for path, gj, gt in _pairs(_np_tree(jg), grads):
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0 if _is_score_bias(path) else 1e-4,
                                   atol=1e-5, err_msg=path)
        n += 1
    assert n >= 20


def test_a_remat_policy_typo_raises():
    t_base.remat_wrap(lambda x: x, "full")
    t_base.remat_wrap(lambda x: x, "save_ctx")
    with pytest.raises(ValueError, match="remat policy"):
        t_base.remat_wrap(lambda x: x, "save-ctx")
    jopt, topt, batch = _case("rfnet_tied", use_remat=1)
    _, tm, jp = _params(jopt, topt)
    params = tree_unflatten(jp, [_t(x).clone() for x in tree_leaves(jp)])
    fcs, atts, labels, _, _ = batch
    with pytest.raises(ValueError, match="remat policy"):
        dataclasses.replace(tm, remat_policy="save-ctx").forward(
            params, [_t(x) for x in fcs], [_t(x) for x in atts], _t(labels))


@pytest.mark.parametrize("case", ["rfnet_tied", "review_net"])
def test_no_checkpointed_step_draws_from_a_generator(case):
    """The trap of torch.utils.checkpoint: it does not replay a draw from
    an explicit torch.Generator, so a step that drew its dropout masks
    inside would recompute with other masks. Every draw of a remat'd
    forward (dropout, scheduled sampling) must fall outside the
    checkpointed functions, in their first run and in the recompute."""
    jopt, topt, batch = _case(case, use_remat=1, **DROPOUT)
    _, tm, jp = _params(jopt, topt)
    params = tree_unflatten(jp, [_t(x).clone() for x in tree_leaves(jp)])
    inside, draws = [0], {"inside": 0, "outside": 0}
    real_checkpoint, real_rand = t_base.checkpoint, torch.rand

    def checkpoint(fn, *args, **kw):
        def guarded(*a):
            inside[0] += 1
            try:
                return fn(*a)
            finally:
                inside[0] -= 1
        return real_checkpoint(guarded, *args, **kw)

    def rand(*a, generator=None, **kw):
        if generator is not None:
            draws["inside" if inside[0] else "outside"] += 1
        return real_rand(*a, generator=generator, **kw)

    with mock.patch.object(t_base, "checkpoint", checkpoint), \
            mock.patch.object(torch, "rand", rand):
        loss, _, (fwd, recomputed, _) = _loss_and_grads(
            tm, topt, params, batch, 0.3, torch.Generator().manual_seed(1), True)
    assert torch.isfinite(loss) and fwd > 0 and recomputed == 0
    assert draws["outside"] > 0 and draws["inside"] == 0, draws


def test_show_tell_ignores_use_remat_as_the_jax_package_does():
    jopt, topt = parity.options("show_tell", use_remat=1)
    tm = t_model(topt)
    assert not hasattr(tm, "use_remat") and not hasattr(j_model(jopt), "use_remat")
