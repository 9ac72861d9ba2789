"""Port ops vs the JAX package's ops: the additive-attention read and the
three RFNet cells, f32 on the CPU, same weights (converted from the JAX
init) and the same numpy inputs. Tolerance rtol 1e-4 / atol 1e-5, as the
existing torch-differential tests use."""

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.ops import attention as t_attention
from recurrent_fusion_network_torch.ops import cells as t_cells
from recurrent_fusion_network_tpu.ops import attention as j_attention
from recurrent_fusion_network_tpu.ops import cells as j_cells

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
B, R, H = 4, 32, 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _feats(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("precomputed", [False, True])
def test_attend_matches_jax(precomputed, masked):
    rng = np.random.default_rng(0)
    A, D = 7, 24
    jp = j_attention.init(jax.random.PRNGKey(1), R, D, H)
    tp = params_from_jax(_np_tree(jp))
    h, att = _feats(rng, B, R), _feats(rng, B, A, D)
    mask = rng.random((B, A)) > 0.3 if masked else None
    jkeys = j_attention.precompute_keys(jp, att) if precomputed else None
    tkeys = t_attention.precompute_keys(tp, torch.from_numpy(att)) if precomputed else None
    jz, jw = j_attention.attend(jp, h, att, keys=jkeys, mask=mask)
    tz, tw = t_attention.attend(tp, torch.from_numpy(h), torch.from_numpy(att),
                                keys=tkeys,
                                mask=None if mask is None else torch.from_numpy(mask))
    _close(tz, jz)
    _close(tw, jw)


def test_attend_heads_matches_vmapped_jax():
    """Stage II's M heads in one grouped read == M separate JAX reads."""
    rng = np.random.default_rng(1)
    M, A, D = 3, 5, 32
    heads = [j_attention.init(k, R, D, H) for k in jax.random.split(jax.random.PRNGKey(2), M)]
    jp = jax.tree_util.tree_map(lambda *x: np.stack(x), *heads)
    tp = params_from_jax(_np_tree(jp))
    h, feats = _feats(rng, B, R), _feats(rng, M, B, A, D)
    tz, tw = t_attention.attend_heads(tp, torch.from_numpy(h), torch.from_numpy(feats))
    for m in range(M):
        jz, jw = j_attention.attend(heads[m], h, feats[m])
        _close(tz[m], jz)
        _close(tw[m], jw)


@pytest.mark.parametrize("maxout", [False, True])
def test_att_lstm_step_matches_jax(maxout):
    rng = np.random.default_rng(3)
    E, A, D = 16, 5, R
    jp = j_cells.att_lstm_init(jax.random.PRNGKey(3), E, R, D, H, maxout=maxout)
    tp = params_from_jax(_np_tree(jp))
    xt, att = _feats(rng, B, E), _feats(rng, B, A, D)
    h, c = _feats(rng, B, R), _feats(rng, B, R)
    jkeys = j_attention.precompute_keys(jp["att"], att)
    jo, (jh, jc) = j_cells.att_lstm_step(jp, xt, att, (h, c), keys=jkeys,
                                         rnn_size=R, maxout=maxout)
    T = torch.from_numpy
    to, (th, tc) = t_cells.att_lstm_step(
        tp, T(xt), T(att), (T(h), T(c)),
        keys=t_attention.precompute_keys(tp["att"], T(att)), rnn_size=R, maxout=maxout)
    for a, b in ((to, jo), (th, jh), (tc, jc)):
        _close(a, b)


@pytest.mark.parametrize("low_rank", [False, True])
@pytest.mark.parametrize("maxout", [False, True])
def test_fusion_lstm_step_matches_jax(maxout, low_rank):
    rng = np.random.default_rng(4)
    M, A, D = 3, 6, 40
    ctx = R if low_rank else None
    jp = j_cells.fusion_lstm_init(jax.random.PRNGKey(4), M * R, R, D, H,
                                  maxout=maxout, ctx_size=ctx)
    tp = params_from_jax(_np_tree(jp))
    Hcat, att = _feats(rng, B, M * R), _feats(rng, B, A, D)
    vals = _feats(rng, B, A, R) if low_rank else att
    h, c = _feats(rng, B, R), _feats(rng, B, R)
    keys = np.array(j_attention.precompute_keys(jp["att"], att))
    jo, (jh, jc) = j_cells.fusion_lstm_step(jp, Hcat, vals, (h, c), keys=keys,
                                            rnn_size=R, maxout=maxout)
    T = torch.from_numpy
    to, (th, tc) = t_cells.fusion_lstm_step(tp, T(Hcat), T(vals), (T(h), T(c)),
                                            keys=T(keys), rnn_size=R, maxout=maxout)
    for a, b in ((to, jo), (th, jh), (tc, jc)):
        _close(a, b)


@pytest.mark.parametrize("maxout", [False, True])
def test_multi_att_lstm_step_matches_jax(maxout):
    rng = np.random.default_rng(5)
    M, A = 3, 4
    jp = j_cells.multi_att_lstm_init(jax.random.PRNGKey(5), R, R, M, H, maxout=maxout)
    tp = params_from_jax(_np_tree(jp))
    feats = _feats(rng, M, B, A, R)
    h, c = _feats(rng, B, R), _feats(rng, B, R)
    jo, (jh, jc) = j_cells.multi_att_lstm_step(jp, feats, (h, c), rnn_size=R,
                                               maxout=maxout)
    T = torch.from_numpy
    to, (th, tc) = t_cells.multi_att_lstm_step(tp, T(feats), (T(h), T(c)),
                                               rnn_size=R, maxout=maxout)
    for a, b in ((to, jo), (th, jh), (tc, jc)):
        _close(a, b)


# ------------------------------------------------- the reference's extra criterions


def _loss_inputs(seed=0, B=3, C=8, T=4, V=9):
    g = np.random.default_rng(seed)
    x = g.standard_normal((B, C)).astype(np.float32)
    y = np.full((B, C), -1, np.int64)
    y[:, 0] = 2
    y[1, 1:4] = (5, 0, 7)
    logits = g.standard_normal((B, T, V)).astype(np.float32)
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    tgt = g.integers(0, V, (B, T))
    msk = np.ones((B, T), np.float32)
    msk[2, 2:] = 0
    return x, y, lp, tgt, msk


@pytest.mark.parametrize("heads", ["list", "single"])
def test_tv_loss_matches_jax(heads):
    """The last head's reason loss, given the heads as a list or one head."""
    import jax.numpy as jnp

    from recurrent_fusion_network_torch.ops import losses as t_losses
    from recurrent_fusion_network_tpu.ops import losses as j_losses

    x, y, _, _, _ = _loss_inputs()
    if heads == "list":
        j_in, t_in = [jnp.asarray(x), jnp.asarray(2 * x)], [torch.from_numpy(x),
                                                             torch.from_numpy(2 * x)]
    else:
        j_in, t_in = jnp.asarray(x), torch.from_numpy(x)
    want = j_losses.tv_loss(j_in, jnp.asarray(y, jnp.int32))
    got = t_losses.tv_loss(t_in, torch.from_numpy(y))
    _close(got, want)
    assert float(got) > 0


def test_smooth_l1_and_soft_att_plus_ltg_loss_match_jax():
    import jax.numpy as jnp

    from recurrent_fusion_network_torch.ops import losses as t_losses
    from recurrent_fusion_network_tpu.ops import losses as j_losses

    x, y, lp, tgt, msk = _loss_inputs(seed=1)
    a = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32) * 2
    b = np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32)
    _close(t_losses.smooth_l1(torch.from_numpy(a), torch.from_numpy(b)),
           j_losses.smooth_l1(jnp.asarray(a), jnp.asarray(b)))
    want = torch.nn.SmoothL1Loss(reduction="sum")(torch.from_numpy(a), torch.from_numpy(b))
    _close(t_losses.smooth_l1(torch.from_numpy(a), torch.from_numpy(b)), want.numpy())
    got = t_losses.soft_att_plus_ltg_loss(torch.from_numpy(lp), torch.from_numpy(tgt),
                                          torch.from_numpy(msk), torch.from_numpy(x),
                                          torch.from_numpy(y), 0.5, 0.001)
    ref = j_losses.soft_att_plus_ltg_loss(jnp.asarray(lp), jnp.asarray(tgt), jnp.asarray(msk),
                                          jnp.asarray(x), jnp.asarray(y, jnp.int32), 0.5, 0.001)
    _close(got, ref)
