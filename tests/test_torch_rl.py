"""The port's SCST path vs the JAX package's, f32 on the CPU.

Inputs come from numpy seeds and weights from the JAX init through
params_from_jax; the tied-keys, untied and low_rank_ctx profiles of
test_torch_train.py. The two frameworks' random streams differ, so draws
are forced (a scripted step function) or compared through what they feed
(the teacher-forced re-evaluation of the port's own samples). Tolerances:
  * SCST losses and their gradients: rtol 1e-5;
  * CIDEr-D scores and rewards: rtol 1e-12 (float64 rounding: the engines
    sum in different orders);
  * sampling on the scripted step: exact;
  * the rollout's log-distributions vs JAX's teacher-forced forward:
    rtol 1e-4 / atol 1e-5;
  * the RL step: loss rtol 1e-5, grads rtol 2e-3 / atol 2e-5, params and
    Adam moments after 3 steps rtol 1e-4 / atol 1e-5 (score biases:
    atol only, as in test_train_step_matches_jax).
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.decoding.sample import sample as t_sample
from recurrent_fusion_network_torch.ops import losses as t_losses
from recurrent_fusion_network_torch.ops.initializers import tree_map
from recurrent_fusion_network_torch.rewards import cider_d as t_cider
from recurrent_fusion_network_torch.rewards import native as t_native
from recurrent_fusion_network_torch.utils import native_build
from recurrent_fusion_network_torch.rewards.self_critical import compute_reward as t_reward
from recurrent_fusion_network_torch.training import optim as t_optim
from recurrent_fusion_network_torch.training import train_rl_loop as t_rl
from recurrent_fusion_network_torch.training.criterion import make_rl_criterion as t_rl_crit
from recurrent_fusion_network_tpu.data.prepro_ngrams import compute_doc_freq
from recurrent_fusion_network_tpu.data.synthetic import synthetic_dataset
from recurrent_fusion_network_tpu.decoding.sample import sample as j_sample
from recurrent_fusion_network_tpu.ops import losses as j_losses
from recurrent_fusion_network_tpu.rewards import cider_d as j_cider
from recurrent_fusion_network_tpu.rewards.self_critical import compute_reward as j_reward
from recurrent_fusion_network_tpu.training import checkpoint as j_ckpt
from recurrent_fusion_network_tpu.training import optim as j_optim
from recurrent_fusion_network_tpu.training.criterion import make_rl_criterion as j_rl_crit
from recurrent_fusion_network_tpu.training.train_rl_loop import make_rl_step as j_rl_step
from recurrent_fusion_network_tpu.training.train_rl_loop import make_rollout_fn as j_rollout

from test_torch_train import (PROFILES, TINY, _batch, _close, _GradSpy, _is_score_bias,
                              _models, _np_tree, _opts, _pairs, _synthetic, _t)

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
LR = 5e-4


def quiet(*_):
    pass


# ------------------------------------------------------------- SCST losses


def _rl_loss_inputs(seed=0, B=4, T=6, V=11, C=9):
    rng = np.random.default_rng(seed)
    lp_all = np.log(rng.dirichlet(np.ones(V), size=(B, T + 1))).astype(np.float32)
    seq = rng.integers(1, V, (B, T))
    seq[0, 1:] = 0  # EOS at the second step
    seq[2, :] = 0  # EOS first
    seq[3, 4:] = 0
    slp = np.take_along_axis(lp_all[:, :T], seq[..., None], axis=2)[..., 0]
    old = (slp + rng.normal(0, 0.3, slp.shape)).astype(np.float32)  # some ratios clip
    reward = np.repeat(rng.normal(0, 1, (B, 1)), T, axis=1).astype(np.float32)
    heads = [rng.standard_normal((B, C)).astype(np.float32) for _ in range(3)]
    top = np.full((B, C), -1, np.int64)
    for b, n in enumerate((2, 9, 0, 4)):
        top[b, :n] = rng.permutation(C)[:n]
    return lp_all, seq, slp, old, reward, heads, top


@pytest.mark.parametrize("use_ppo", [False, True])
@pytest.mark.parametrize("loss", ["reward_loss", "review_net_ensemble", "review_net_one_head"])
def test_rl_losses_and_their_gradients_match_jax(loss, use_ppo):
    """Rows that end at once, early, late and never; PPO ratios inside and
    outside the clip range; the entropy term on."""
    lp_all, seq, slp, old, reward, heads, top = _rl_loss_inputs()
    kw = dict(use_ppo=use_ppo, ppo_clip=0.2)

    def jfn(slp_, lp_all_):
        if loss == "reward_loss":
            return j_losses.reward_loss(slp_, seq, reward, lp_all_, 0.05, old, **kw)
        top_pred = heads if loss == "review_net_ensemble" else heads[0]
        return j_losses.review_net_reward_loss(slp_, seq, reward, lp_all_, 0.05, top_pred,
                                               top, 0.7, old, max_targets=5, **kw)

    jl, (jg_slp, jg_all) = jax.value_and_grad(jfn, argnums=(0, 1))(slp, lp_all)
    tslp, tall = _t(slp).requires_grad_(), _t(lp_all).requires_grad_()
    args = (_t(seq), _t(reward), tall, 0.05)
    if loss == "reward_loss":
        tl = t_losses.reward_loss(tslp, *args, _t(old), **kw)
    else:
        top_pred = [_t(h) for h in heads] if loss == "review_net_ensemble" else _t(heads[0])
        tl = t_losses.review_net_reward_loss(tslp, *args, top_pred, _t(top), 0.7, _t(old),
                                             max_targets=5, **kw)
    tl.backward()
    _close(tl, jl, rtol=LOSS_RTOL, atol=0)
    _close(tslp.grad, jg_slp, rtol=LOSS_RTOL, atol=1e-7)
    _close(tall.grad, jg_all, rtol=LOSS_RTOL, atol=1e-7)
    if use_ppo:
        with pytest.raises(ValueError, match="sample_logprobs_old"):
            t_losses.reward_loss(tslp, *args, None, **kw)


def test_rl_masks_reward_the_eos_step():
    seq = torch.tensor([[4, 0, 0], [2, 3, 1], [0, 0, 0]])
    mask_0, mask = t_losses._rl_masks(seq)
    assert mask_0.tolist() == [[1, 0, 0], [1, 1, 1], [0, 0, 0]]
    assert mask.tolist() == [[1, 1, 0], [1, 1, 1], [1, 0, 0]]


@pytest.mark.parametrize("name", ["show_tell", "review_net", "unknown"])
def test_rl_criterion_takes_the_rfnet_model_only(name):
    """Every model's SCST criterion equals the JAX package's, loss and
    gradients (ShowTell: the policy-gradient loss alone; ReviewNet: plus
    its one reason head), with PPO; an unknown model is a ValueError."""
    from recurrent_fusion_network_torch.config import Options
    from recurrent_fusion_network_tpu.config import Options as JaxOptions

    kw = dict(caption_model=name, use_ppo=1, ppo_clip=0.1, entropy_reg=0.05,
              reason_weight=0.7, seq_length=3)
    if name == "unknown":
        with pytest.raises(ValueError, match="not supported"):
            t_rl_crit(Options(**kw))
        return
    lp_all, seq, slp, old, reward, heads, top = _rl_loss_inputs()
    jcrit = j_rl_crit(JaxOptions(feature_type="synthetic", **kw))
    jl, (jg_slp, jg_all) = jax.value_and_grad(
        lambda a, b: jcrit(a, seq, reward, b, heads[:1], top, old), argnums=(0, 1))(slp, lp_all)
    tslp, tall = _t(slp).requires_grad_(), _t(lp_all).requires_grad_()
    tl = t_rl_crit(Options(**kw))(tslp, _t(seq), _t(reward), tall, [_t(heads[0])], _t(top),
                                  _t(old))
    tl.backward()
    _close(tl, jl, rtol=LOSS_RTOL, atol=0)
    _close(tslp.grad, jg_slp, rtol=LOSS_RTOL, atol=1e-7)
    _close(tall.grad, jg_all, rtol=LOSS_RTOL, atol=1e-7)


# --------------------------------------------------------- CIDEr-D rewards


def _reward_case(seed=4, B_img=4, spi=2, T=7):
    ds = synthetic_dataset(n_train=40, seed=seed)
    train = ds.splits()["train"]
    df = compute_doc_freq(ds, train)
    ref_len = float(np.log(len(train)))
    g = np.random.default_rng(seed)
    gts = [ds.captions_for_image(train[i]) for i in range(B_img)]
    gen = g.integers(0, ds.vocab_size + 1, (B_img * spi, T))
    gen[0, :] = np.append(gts[0][0][:T - 1], 0)  # a sample equal to a reference
    greedy = np.stack([gts[i][1][:T] for i in range(B_img) for _ in range(spi)])
    greedy[-1, 3:] = 0
    return df, ref_len, gts, gen, greedy, ds.vocab_size


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_cider_d_scores_match_jax(engine):
    """Both of the port's engines against both of the JAX package's, to
    float64 rounding; tuple-keyed and pre-hashed df give the same scores."""
    df, ref_len, gts, gen, greedy, _ = _reward_case()
    hyps = list(gen) + list(greedy)
    refs = [gts[i // 2] for i in range(len(gen))] * 2
    keys = [i // 2 for i in range(len(gen))] * 2
    port = t_cider.CiderD(df, ref_len, backend=engine)
    assert port.engine == engine
    got = port.score_arrays(hyps, refs, keys)
    for jengine in ("numpy", "native"):
        want = j_cider.CiderD(df, ref_len, backend=jengine).score_arrays(hyps, refs, keys)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert got.max() > 1.0 and got.min() >= 0.0
    hashed = {t_cider.hash_ngram_tuple(g): v for g, v in df.items()}
    np.testing.assert_allclose(
        t_cider.CiderD(hashed, ref_len, backend=engine).score_arrays(hyps, refs), got,
        rtol=1e-12, atol=0)
    np.testing.assert_array_equal(t_cider.trim_with_eos([3, 5, 0, 7, 0]), [3, 5, 0])
    for n in (1, 3):
        tk, tc, tl = t_cider.hash_ngrams(gen[1], n)
        jk, jc, jl = j_cider.hash_ngrams(gen[1], n)
        assert tl == jl and all(np.array_equal(a, b) for a, b in zip(tk + tc, jk + jc))


def test_cider_d_guards_raise_as_in_jax(tmp_path):
    df, ref_len, gts, _, _, _ = _reward_case()
    caps = list(gts[0])
    cases = {
        "KEY_BASE": ([np.array([1, int(2 ** 15)])], [caps]),
        "negative": ([caps[0], caps[0]], [caps + [np.array([1, -1])], caps]),
        "empty reference set": ([caps[0]], [[]]),
    }
    for engine in ("numpy", "native"):
        port = t_cider.CiderD(df, ref_len, backend=engine)
        jref = j_cider.CiderD(df, ref_len, backend=engine)
        for match, (hyps, refs) in cases.items():
            for scorer in (port, jref):
                with pytest.raises(ValueError, match=match):
                    scorer.score_arrays(hyps, refs)
    for n in (0, 5):
        for cls in (t_cider.CiderD, j_cider.CiderD):
            with pytest.raises(ValueError, match="int64 key capacity"):
                cls(df, ref_len, n=n)
    import pickle

    path = tmp_path / "df.p"
    with open(path, "wb") as f:
        pickle.dump({"document_frequency": df, "ref_len": ref_len}, f)
    hyps = [caps[0], caps[1]]
    np.testing.assert_allclose(
        t_cider.CiderD.from_pickle(str(path), backend="numpy").score_arrays(hyps, [caps] * 2),
        j_cider.CiderD.from_pickle(str(path)).score_arrays(hyps, [caps] * 2), rtol=1e-12)


def test_native_engine_needs_a_compiler_and_auto_falls_back(monkeypatch):
    df, ref_len, _, _, _, _ = _reward_case()
    monkeypatch.setattr(t_native.LIBRARY, "_lib", None)
    monkeypatch.setattr(t_native.LIBRARY, "fresh", lambda: False)
    monkeypatch.setattr(native_build, "compiler", lambda: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        t_cider.CiderD(df, ref_len, backend="native")
    with pytest.warns(UserWarning, match="NumPy engine"):
        assert t_cider.CiderD(df, ref_len).engine == "numpy"
    assert t_native.LIB.parent.name == "native" and t_native.LIB.parents[1].name == "build"


@pytest.mark.parametrize("use_baseline, bleu4_weight", [(True, 0.0), (False, 0.0),
                                                       (True, 0.5)])
def test_compute_reward_matches_jax(use_baseline, bleu4_weight):
    df, ref_len, gts, gen, greedy, _ = _reward_case()
    kw = dict(use_baseline=use_baseline, cider_weight=0.8, bleu4_weight=bleu4_weight)
    got = t_reward(t_cider.CiderD(df, ref_len), gen, greedy, gts, **kw)
    want = j_reward(j_cider.CiderD(df, ref_len), gen, greedy, gts, **kw)
    assert got.shape == gen.shape and (got == got[:, :1]).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert np.abs(got).max() > 0.1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_reward(t_cider.CiderD(df, ref_len), gen, greedy, gts, spice_weight=0.5)
    with pytest.raises(ValueError, match="divide"):
        t_reward(t_cider.CiderD(df, ref_len), gen[:-1], greedy[:-1], gts)


# ------------------------------------------------------------ sampling


def _scripted_table(seed=3, B=6, L=7, V=6):
    """(L+1, B, V, V) log-prob rows by (step, row, fed token): one token
    per row at a log-prob in [-3, -0.1], the rest near -1e4, so any draw
    is forced. Row r emits EOS at step eos[r] whatever it was fed; after
    that it is fed the raw phantom draws; every row has ended by step 5."""
    rng = np.random.default_rng(seed)
    eos = [2, 4, 1, 3, 5, 2]
    table = (-1e4 + rng.uniform(0, 1, (L + 1, B, V, V))).astype(np.float32)
    for t in range(L + 1):
        for r in range(B):
            for fed in range(V):
                tok = 0 if t + 1 == eos[r] else int(rng.integers(1, V))
                table[t, r, fed, tok] = rng.uniform(-3, -0.1)
    return table


def test_sample_with_greedy_mask_matches_jax_on_forced_draws():
    """EOS latching, phantom draws after a row ends (fed, not recorded) and
    the zero tail once every row has ended; half the rows greedy."""
    B, L, V = 6, 7, 6
    table = _scripted_table(B=B, L=L, V=V)
    carry = np.stack([np.zeros(B), np.arange(B)], 1).astype(np.float32)
    fed_t, fed_j = [], []

    def j_step(tokens, c):
        return jnp.asarray(table)[c[:, 0].astype(jnp.int32), c[:, 1].astype(jnp.int32),
                                  tokens], c.at[:, 0].add(1.0)

    def t_step(tokens, c):
        fed_t.append(tokens.clone())
        tt = torch.from_numpy(table)
        return tt[c[:, 0].long(), c[:, 1].long(), tokens], c + torch.tensor([1.0, 0.0])

    mask = np.arange(B) >= B // 2
    j = j_sample(j_step, jnp.asarray(carry), B, L, V, rng=jax.random.PRNGKey(5),
                 greedy_mask=jnp.asarray(mask))
    t = t_sample(t_step, torch.from_numpy(carry), B, L, V, greedy_mask=torch.from_numpy(mask),
                 generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(t.seq.numpy(), np.asarray(j.seq))
    np.testing.assert_array_equal(t.seq_logprobs.numpy(), np.asarray(j.seq_logprobs))
    np.testing.assert_array_equal(t.logprobs_all.numpy(), np.asarray(j.logprobs_all))
    seq, slp = t.seq.numpy(), t.seq_logprobs.numpy()
    assert (seq[:, 0] > 0).sum() == 5  # row 2 ends at once
    assert (slp[:, 5:] == 0).all() and (slp[:, :5] != 0).all()  # zero tail once all ended
    fed = torch.stack(fed_t, 1).numpy()  # (B, L+1) raw tokens fed
    assert fed[2, 2] > 0 and seq[2, 1] == 0  # a phantom draw: fed, not recorded


# --------------------------------------------------------------- rollout


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_rollout_matches_jax_greedy_and_teacher_forcing(profile):
    """The greedy half equals JAX's greedy tokens. The sampled half's
    per-step log-distributions equal JAX's teacher-forced forward on the
    port's own samples at every step the RL mask keeps."""
    jm, tm, jp = _models(profile)
    fcs, atts, _, _, _ = _batch(seed=2, B=5)
    tp = params_from_jax(_np_tree(jp))
    captured = []

    def spy(*a, **k):
        captured.append(t_sample(*a, **k))
        return captured[-1]

    rollout = t_rl.make_rollout_fn(tm)
    args = (tp, [_t(x) for x in fcs], [_t(x) for x in atts])
    with mock.patch.object(t_rl, "sample", spy):
        seq, greedy = rollout(*args, torch.Generator().manual_seed(0))
    again, _ = rollout(*args, torch.Generator().manual_seed(0))
    assert torch.equal(seq, again) and seq.dtype == greedy.dtype == torch.int64
    _, jgreedy = j_rollout(jm)(jp, fcs, atts, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    assert not torch.equal(seq, greedy)

    B, L = seq.shape
    seq_np = seq.numpy()
    jlps, _ = jm.forward(jp, fcs, atts, np.asarray(t_rl.seq_to_inputs(seq)))
    keep = np.concatenate([np.ones((B, 1), bool), seq_np[:, :-1] > 0], 1)
    lps = captured[0].logprobs_all[:B, :L].numpy()
    np.testing.assert_allclose(lps[keep], np.asarray(jlps)[:, :L][keep], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(captured[0].seq[:B].numpy(), seq_np)


# --------------------------------------------------------------- RL step


def _rl_batch(seed=7, B=4):
    rng = np.random.default_rng(seed)
    L, V = TINY["seq_length"], TINY["vocab_size"]
    seq = rng.integers(1, V + 1, (B, L))
    seq[0, 2:] = 0
    seq[1, 0:] = 0
    seq[2, 4:] = 0
    reward = np.repeat(rng.normal(0, 1, (B, 1)), L, axis=1).astype(np.float32)
    return seq, reward


@pytest.mark.parametrize("profile, use_ppo", [("tied", False), ("tied", True),
                                              ("untied", False), ("low_rank_ctx", True)])
def test_rl_step_matches_jax(profile, use_ppo):
    """Loss and every grad leaf of the first step, then params and Adam
    moments after 3 steps on the same seq and reward (PPO: the same frozen
    log-probs, each package its own)."""
    jm, tm, jp = _models(profile)
    jopt, topt = _opts(profile, grad_clip=0.05, use_ppo=int(use_ppo), ppo_clip=0.1,
                       entropy_reg=0.05)
    fcs, atts, _, _, top = _batch()
    seq, reward = _rl_batch()
    jcrit, jtx = j_rl_crit(jopt), j_optim.make_optimizer(jopt)
    jstep, jold = j_rl_step(jm, jcrit, jtx)
    jslp_old = np.asarray(jold(jp, fcs, atts, seq)) if use_ppo else np.zeros_like(reward)

    def jloss(p):
        lps, reason = jm.forward(p, fcs, atts, np.asarray(t_rl.seq_to_inputs(_t(seq))))
        slp = jnp.take_along_axis(lps[:, :seq.shape[1]], seq[..., None], axis=2)[..., 0]
        return jcrit(slp, seq, reward, lps, reason, top, jslp_old)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    jparams, jstate = jax.tree_util.tree_map(jnp.array, jp), jtx.init(jp)
    for _ in range(3):
        jparams, jstate, _ = jstep(jparams, jstate, fcs, atts, seq, reward, top, LR, jslp_old)

    tp = params_from_jax(_np_tree(jp))
    spy = _GradSpy(t_optim.make_optimizer(topt))
    step, old = t_rl.make_rl_step(tm, t_rl_crit(topt), spy)
    fc_t, att_t = [_t(x) for x in fcs], [_t(x) for x in atts]
    tseq = _t(seq)
    slp_old = old(tp, fc_t, att_t, tseq) if use_ppo else torch.zeros(seq.shape)
    if use_ppo:
        _close(slp_old, jslp_old, msg="old log-probs")
        assert not slp_old.requires_grad
    state = spy.init(tp)
    losses = []
    for _ in range(3):
        tp, state, loss = step(tp, state, fc_t, att_t, tseq, _t(reward), _t(top), LR, slp_old)
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], float(jl), rtol=LOSS_RTOL)

    n = 0
    for path, gj, gt in _pairs(_np_tree(jg), spy.grads):
        _close(gt, gj, rtol=0 if _is_score_bias(path) else GRAD_RTOL, atol=GRAD_ATOL,
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


# --------------------------------------------------------------- train_rl


def _scorer(loader):
    ds, train = loader.dataset, loader.split_image_id["train"]
    return t_cider.CiderD(compute_doc_freq(ds, train), float(np.log(len(train))))


def _rl_synthetic(**over):
    return _synthetic(**{"batch_size": 3, "seq_per_img": 2, **over})


def _loader_state(loader):
    return {"iterators": dict(loader.iterators),
            "split_image_id": {s: list(v) for s, v in loader.split_image_id.items()},
            "loader_rng": dict(loader.rng_states)}


def _record_rewards(calls):
    real = t_rl.compute_reward

    def rec(scorer, gen, greedy, gts, **kw):
        calls.append((gen.copy(), greedy.copy()))
        return real(scorer, gen, greedy, gts, **kw)

    return rec


def _xe_checkpoint(tmp_path, jopt, topt, loader, run_id, *, best, prefix="", extra=None):
    """A checkpoint triple written by the JAX package: seeded params (drawn
    by the port, in the JAX tree layout), an optax adam chain state with
    count 2 and seeded moments, and the loader's state after 2 batches.
    -> (params, optax state) as numpy trees."""
    topt.vocab_size, topt.seq_length = loader.vocab_size, loader.seq_length
    tp = t_rl.setup(topt).init_params(torch.Generator().manual_seed(3), device="cpu")
    p = jax.tree_util.tree_map(lambda x: x.numpy(), tp)
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(j_optim.make_optimizer(jopt).init, p)
    state = jax.tree_util.tree_map(
        lambda x: np.abs(rng.standard_normal(x.shape)).astype(x.dtype) * 1e-3, shapes)
    state = (*state[:-1], state[-1]._replace(count=np.asarray(2, np.int32)))
    for _ in range(2):
        loader.get_batch("train")
    infos = {"iter": 7, "epoch": 0, "opt": dict(vars(jopt)),
             "lr_history": {0: 5e-4, 3: 4e-4}, "loss_history": {0: 9.0, 3: 8.0},
             **_loader_state(loader), **(extra or {})}
    j_ckpt.save_checkpoint(str(tmp_path), run_id, 0, params=p, opt_state=state,
                           infos=infos, best=best, prefix=prefix)
    return p, state


def test_train_rl_warm_starts_from_a_jax_xe_best_triple(tmp_path):
    """Params and loader state from the JAX-written XE best triple: the
    first greedy rollout is the greedy decode of the checkpoint's params on
    the batch the restored JAX loader gives (the rollout's greedy half is
    held against JAX's above); the iteration count and the XE histories
    continue; the optimizer starts afresh at optim_rl_lr."""
    jopt, topt, loader = _rl_synthetic()
    p, _ = _xe_checkpoint(tmp_path, jopt, topt, loader, "xe", best=True)
    restored = _rl_synthetic()[2]
    restored.restore_state(*_loader_state(loader).values())
    d = restored.get_batch("train")
    _, want = t_rl.make_rollout_fn(t_rl.setup(topt))(
        params_from_jax(_np_tree(p)), [_t(x) for x in d["fc_feats_array"]],
        [_t(x) for x in d["att_feats_array"]], torch.Generator().manual_seed(0))

    topt.start_from, topt.load_model_id = str(tmp_path), "xe"
    calls = []
    with mock.patch.object(t_rl, "compute_reward", _record_rewards(calls)):
        infos = t_rl.train_rl(topt, _rl_synthetic()[2], _scorer(loader), max_iterations=9,
                              log_fn=quiet)
    np.testing.assert_array_equal(calls[0][1], want.numpy())
    assert infos["iter"] == 9 and sorted(infos["loss_history"]) == [0, 3, 7, 8]
    assert infos["rl_lr_base"] == topt.optim_rl_lr and infos["lr_history"][8] == 5e-5
    assert infos["final_opt_state"].count == 2
    moved = 0.0
    for path, a, b in _pairs(_np_tree(p), infos["final_params"]):
        d = np.abs(b.numpy() - np.asarray(a)).max()
        assert d <= 2 * 5e-5 * (1 + 1e-3), path  # two Adam steps of at most lr
        moved = max(moved, d)
    assert moved > 1e-5


def _adam_copy(state):
    return t_optim.AdamState(state.count, tree_map(torch.clone, state.mu),
                             tree_map(torch.clone, state.nu))


def test_train_rl_resumes_a_jax_rl_triple_and_derives_the_load_lr_base(tmp_path):
    """--rl_resume: the rl_ triple's rl_lr_base and its Adam moments (the
    state the first update receives); --load_lr from the XE best triple:
    base = min(lr history) / optim_rl_lr_ratio, moments adopted too (both
    triples hold the same seeded moments)."""
    jopt, topt, loader = _rl_synthetic()
    _, jstate = _xe_checkpoint(tmp_path, jopt, topt, loader, "rl", best=False, prefix="rl_",
                               extra={"rl_lr_base": 3e-5})
    _xe_checkpoint(tmp_path, jopt, topt, _rl_synthetic()[2], "xe", best=True)
    adam = _np_tree(jstate[-1])
    for case in ("rl_resume", "load_lr"):
        _, topt, tl = _rl_synthetic()
        topt.start_from = str(tmp_path)
        if case == "rl_resume":
            topt.load_model_id, topt.rl_resume = "rl", 1
        else:
            topt.load_model_id, topt.load_lr = "xe", 1
        firsts = []

        def make_spy(opt):
            spy = _GradSpy(t_optim.make_optimizer(opt))
            spy.name, real = spy.tx.name, spy.update

            def update(grads, state, params):
                if not firsts:
                    firsts.append(_adam_copy(state))
                return real(grads, state, params)

            spy.update = update
            return spy

        with mock.patch.object(t_rl, "make_optimizer", make_spy):
            infos = t_rl.train_rl(topt, tl, _scorer(tl), max_iterations=9, log_fn=quiet)
        base = 3e-5 if case == "rl_resume" else 4e-4 / 2.0
        assert infos["rl_lr_base"] == pytest.approx(base)
        assert infos["lr_history"][7] == infos["lr_history"][8] == pytest.approx(base)
        assert infos["final_opt_state"].count == 2 + 2
        assert firsts[0].count == 2
        for name in ("mu", "nu"):
            for path, mj, mt in _pairs(getattr(adam, name), getattr(firsts[0], name)):
                np.testing.assert_array_equal(mt.numpy(), mj, err_msg=f"{name} {path}")


def test_train_rl_overlap_is_trajectory_identical_to_the_serial_loop():
    """--rl_overlap 1 and 0: the same reward and loss histories and
    bit-identical final params; rewards vary and the loss is finite."""
    runs = []
    for overlap in (1, 0):
        _, topt, loader = _rl_synthetic(seed=11)
        topt.rl_overlap = overlap
        runs.append(t_rl.train_rl(topt, loader, _scorer(loader), max_iterations=4,
                                  log_fn=quiet))
    a, b = runs
    assert a["loss_history"] == b["loss_history"] and len(a["loss_history"]) == 4
    assert a["train_loss_history"] == b["train_loss_history"]
    assert all(np.isfinite(v) for v in a["train_loss_history"].values())
    assert len(set(a["loss_history"].values())) > 1
    for path, x, y in _pairs(a["final_params"], b["final_params"]):
        assert torch.equal(x, y), path


def test_train_rl_ppo_takes_ppo_k_plus_one_steps_per_iteration():
    _, topt, loader = _rl_synthetic()
    topt.use_ppo, topt.ppo_k = 1, 2
    infos = t_rl.train_rl(topt, loader, _scorer(loader), max_iterations=2, log_fn=quiet)
    assert infos["final_opt_state"].count == 2 * 3
    assert all(np.isfinite(v) for v in infos["train_loss_history"].values())


def test_train_rl_evaluates_and_writes_rl_triples_at_boundaries_and_raises_for_spice(tmp_path):
    """train_rl() evaluates at iterations 2 and 4 and writes the rl_ triple
    there; SPICE rewards raise."""
    _, topt, loader = _rl_synthetic(save_checkpoint_every=2)
    topt.checkpoint_path, topt.id = str(tmp_path), "b"
    topt.eval_results_dir = str(tmp_path / "eval_results")
    infos = t_rl.train_rl(topt, loader, _scorer(loader), max_iterations=5, log_fn=quiet)
    assert infos["iter"] == 5 and sorted(infos["val_result_history"]) == [2, 4]
    assert os.path.exists(tmp_path / "rl_model_b_0.pkl")
    _, topt, loader = _rl_synthetic()
    topt.spice_weight = 0.3
    with pytest.raises(NotImplementedError, match="SPICE"):
        t_rl.train_rl(topt, loader, _scorer(loader), max_iterations=1, log_fn=quiet)


def test_train_rl_needs_cuda_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, topt, loader = _rl_synthetic()
    topt.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_rl.train_rl(topt, loader, _scorer(loader), max_iterations=1)
    _, topt, loader = _rl_synthetic()
    topt.device = None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_rl.train_rl(topt, loader, _scorer(loader), max_iterations=1)



def test_get_self_critical_reward_matches_jax():
    """The greedy-baseline reward on a tiny RFNet with converted weights:
    the default rollout (model_sample at beam 1, arg-max) gives JAX's greedy
    tokens, and the rewards equal JAX's; greedy_sample_fn overrides the
    rollout, as in JAX."""
    from recurrent_fusion_network_torch.decoding.api import model_sample as t_model_sample
    from recurrent_fusion_network_torch.rewards.self_critical import (
        get_self_critical_reward as t_scr,
    )
    from recurrent_fusion_network_tpu.decoding.api import model_sample as j_model_sample
    from recurrent_fusion_network_tpu.rewards.self_critical import (
        get_self_critical_reward as j_scr,
    )

    jm, tm, jp = _models("tied")
    jp = _np_tree(jp)
    # larger logits and EOS held back, so the greedy captions are neither
    # empty nor alike
    jp["logit"] = dict(w=jp["logit"]["w"] * 4, b=jp["logit"]["b"].copy())
    jp["logit"]["b"][0] = -3.0
    tp = params_from_jax(jp)
    fcs, atts, _, _, _ = _batch(seed=5, B=4)
    tfc, tatt = [_t(x) for x in fcs], [_t(x) for x in atts]
    jgreedy = np.asarray(j_model_sample(jm, jp, fcs, atts, beam_size=1, sample_max=True).seq)
    with torch.inference_mode():
        tgreedy = t_model_sample(tm, tp, tfc, tatt, beam_size=1, sample_max=True).seq
    np.testing.assert_array_equal(tgreedy.numpy(), jgreedy)
    assert (jgreedy[:, 0] > 0).all() and len({r.tobytes() for r in jgreedy}) > 1

    df, ref_len, gts, _, _, _ = _reward_case(B_img=2, spi=2, T=TINY["seq_length"])
    gts = [np.concatenate([jgreedy[:1], g[:, :jgreedy.shape[1]]]) for g in gts[:1]] + \
        [g[:, :jgreedy.shape[1]] for g in gts[1:]]  # image 0's greedy row is a reference
    gen = np.random.default_rng(6).integers(0, TINY["vocab_size"] + 1, jgreedy.shape)
    gen[3] = gts[1][0]
    kw = dict(cider_weight=0.8, bleu4_weight=0.5)
    want = j_scr(jm, jp, fcs, atts, gts, gen, j_cider.CiderD(df, ref_len), **kw)
    got = t_scr(tm, tp, tfc, tatt, gts, torch.from_numpy(gen), t_cider.CiderD(df, ref_len), **kw)
    assert got.shape == gen.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(
        got, t_reward(t_cider.CiderD(df, ref_len), gen, tgreedy.numpy(), gts, **kw))
    assert np.abs(got[:, 0]).max() > 0.1 and len(set(got[:, 0])) > 1

    def fixed(params, fc, att):
        assert params is tp and fc is tfc and att is tatt
        return torch.zeros_like(tgreedy)

    got0 = t_scr(tm, tp, tfc, tatt, gts, gen, t_cider.CiderD(df, ref_len),
                 greedy_sample_fn=fixed, **kw)
    np.testing.assert_array_equal(
        got0, t_reward(t_cider.CiderD(df, ref_len), gen, np.zeros_like(gen), gts, **kw))
