"""The port's ShowTell model vs the JAX package's, f32 on the CPU at tiny
widths, with 1 and 2 layers: the bias-free cell, encode / decode /
forward, greedy and beam-3 tokens, the XE and SCST steps, checkpoint
triples both ways, the three CLIs and the HTTP front end. Tolerances are
those of tests/_single_encoder_parity.py: outputs rtol 1e-4 / atol 1e-5,
tokens identical, step losses rtol 1e-5, grads rtol 2e-3 / atol 2e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.models import setup as t_model
from recurrent_fusion_network_torch.ops import cells as t_cells
from recurrent_fusion_network_torch.training.checkpoint import cast_tree
from recurrent_fusion_network_tpu.models import setup as j_model
from recurrent_fusion_network_tpu.ops import cells as j_cells

import _single_encoder_parity as parity
from test_torch_train import _close, _np_tree, _t

torch.set_num_threads(1)
LAYERS = [1, 2]


def _pair(num_layers, **over):
    return parity.options("show_tell", num_layers=num_layers, **over)


def test_plain_lstm_step_matches_jax():
    g = np.random.default_rng(0)
    jp = _np_tree(j_cells.plain_lstm_init(jax.random.PRNGKey(0), 6, 8))
    x = g.standard_normal((3, 6)).astype(np.float32)
    h, c = (g.standard_normal((3, 8)).astype(np.float32) for _ in range(2))
    jout, (jh, jc) = j_cells.plain_lstm_step(jp, x, (h, c), rnn_size=8)
    tout, (th, tc) = t_cells.plain_lstm_step(params_from_jax(jp), _t(x), (_t(h), _t(c)),
                                             rnn_size=8)
    for a, b in ((tout, jout), (th, jh), (tc, jc)):
        _close(a, b)


def test_init_layout_bounds_and_fills():
    """The port's init has the JAX tree (shapes and keys); the bias-free
    layers within U(+-1/sqrt(R)), img_embed within the nn.Linear default
    bound of its fan-in, the embedding within U(+-0.1). The two packages'
    random streams differ, so bounds are held, not values."""
    jopt, topt = _pair(2)
    jm, tm = j_model(jopt), t_model(topt)
    jp = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(tp)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(tp)):
        assert a.shape == tuple(b.shape), path
    for layer in tp["core"]:
        assert set(layer) == {"i2h", "h2h"} and all(set(v) == {"w"} for v in layer.values())
        for v in layer.values():
            assert v["w"].abs().max() <= 1 / math.sqrt(16) and v["w"].std() > 0.05
    bound = 1 / math.sqrt(parity.FC)
    assert tp["img_embed"]["w"].abs().max() <= bound < tp["img_embed"]["w"].abs().max() * 1.5
    assert tp["img_embed"]["b"].abs().max() <= bound
    assert tp["embed"].abs().max() <= 0.1 and (tp["logit"]["b"].abs() <= 0.1).all()


@pytest.mark.parametrize("num_layers", LAYERS)
def test_encode_decode_and_forward_match_jax(num_layers):
    parity.check_forward(*parity.models(*_pair(num_layers)))


@pytest.mark.parametrize("beam_size", [1, 3])
@pytest.mark.parametrize("num_layers", LAYERS)
def test_greedy_and_beam_tokens_match_jax(num_layers, beam_size):
    parity.check_tokens(*parity.models(*_pair(num_layers)), beam_size)


@pytest.mark.parametrize("num_layers", LAYERS)
def test_xe_step_matches_jax(num_layers):
    parity.check_xe_step(*_pair(num_layers), min_leaves=5 + 2 * num_layers)


@pytest.mark.parametrize("num_layers", LAYERS)
def test_scst_step_matches_jax(num_layers):
    parity.check_rl_step(*_pair(num_layers), min_leaves=5 + 2 * num_layers)


def test_rollout_greedy_half_matches_jax():
    parity.check_rollout_greedy(*_pair(2))


def test_bf16_state_and_logits_are_f32_as_in_jax():
    """With bf16 weights the f32 zero state promotes the recurrent state and
    the logits to f32 in both packages; the log-probs agree to a bf16
    tolerance (rtol 2e-2 / atol 2e-2)."""
    jopt, topt = _pair(2)
    jm, tm, jp, tp = parity.models(jopt, topt)
    jp16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), jp)
    tp16 = cast_tree(tp, torch.bfloat16)
    fc, att, labels, _, _ = parity.batch()
    jenc = jm.encode(jp16, jnp.asarray(fc, jnp.bfloat16), None)
    tenc = tm.encode(tp16, [_t(fc).to(torch.bfloat16)], None)
    assert {str(x.dtype) for x in jax.tree_util.tree_leaves(jenc.state)} == {"float32"}
    assert {x.dtype for layer in tenc.state for x in layer} == {torch.float32}
    jlogits, _ = jm.decode_logits(jp16, jm.embed(jp16, labels[:, 1]), None, jenc.state)
    tlogits, _ = tm.decode_logits(tp16, tm.embed(tp16, _t(labels[:, 1])), None, tenc.state)
    assert str(jlogits.dtype) == "float32" and tlogits.dtype == torch.float32
    jlps, _ = jm.forward(jp16, jnp.asarray(fc, jnp.bfloat16), None, labels)
    tlps, _ = tm.forward(tp16, [_t(fc).to(torch.bfloat16)], None, _t(labels))
    _close(tlps, jlps, rtol=2e-2, atol=2e-2)


def test_checkpoints_load_both_ways(tmp_path):
    parity.check_checkpoints_both_ways(tmp_path, *_pair(2))


def test_main_eval_main_rl_on_the_cpu(tmp_path, capsys):
    parity.check_clis(tmp_path, capsys, "show_tell", "--num_layers", "2")


def test_http_front_end_answers_caption(tmp_path):
    """ShowTell reads no attention features: the request's att may have
    any width."""
    jopt, _ = _pair(1)
    svc = parity.check_http(tmp_path, jopt, (1, 3))
    assert svc.single and svc.server.feat_dims == ((parity.FC,), (None,))
