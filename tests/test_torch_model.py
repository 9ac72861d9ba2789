"""Port RecurrentFusionModel vs the JAX model: encode (thoughts, keys,
decoder state, all M+1 reason heads) and decode_logprobs, f32 on the CPU,
for the tied-keys default, untied --reference_parity and low_rank_ctx
profiles. Weights come from the JAX init through params_from_jax; inputs
from a numpy seed. Tolerance rtol 1e-4 / atol 1e-5."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.convert import check_params, params_from_jax
from recurrent_fusion_network_torch.models import RecurrentFusionModel as TorchRFNet
from recurrent_fusion_network_tpu.models import RecurrentFusionModel as JaxRFNet

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
B = 3
TINY = dict(vocab_size=50, seq_length=6, fc_feat_sizes=(24, 16, 20),
            att_feat_sizes=(40, 24, 32), att_nums=(7, 5, 6),
            input_encoding_size=32, rnn_size=32, att_hid_size=32,
            num_review_steps=2, num_review_steps_0=2, top_words_count=30)
PROFILES = {
    "tied": dict(tied_att_keys=True),
    "untied": dict(tied_att_keys=False),
    "low_rank_ctx": dict(tied_att_keys=True, low_rank_ctx=True),
}


def models(profile, **over):
    kw = {**TINY, **PROFILES[profile], **over}
    jm = JaxRFNet(**kw)
    tm = TorchRFNet(**{f.name: kw[f.name] for f in dataclasses.fields(TorchRFNet)
                       if f.name in kw})
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def features(seed=0, batch=B):
    rng = np.random.default_rng(seed)
    fcs = [rng.standard_normal((batch, d)).astype(np.float32) for d in TINY["fc_feat_sizes"]]
    atts = [rng.standard_normal((batch, n, d)).astype(np.float32)
            for n, d in zip(TINY["att_nums"], TINY["att_feat_sizes"])]
    return fcs, atts


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_encode_and_decode_logprobs_match_jax(profile):
    jm, jp, tm, tp = models(profile, fusion_maxout=profile == "untied",
                            review_maxout=profile == "low_rank_ctx")
    fcs, atts = features()
    jenc = jm.encode(jp, fcs, atts)
    tenc = tm.encode(tp, [torch.from_numpy(x) for x in fcs],
                     [torch.from_numpy(x) for x in atts])
    _close(tenc.memory["thoughts"], jenc.memory["thoughts"])
    _close(tenc.memory["keys"], jenc.memory["keys"])
    for a, b in zip(tenc.state, jenc.state):
        _close(a, b)
    assert len(tenc.reason_preds) == len(jenc.reason_preds) == 4
    for a, b in zip(tenc.reason_preds, jenc.reason_preds):
        _close(a, b)

    tokens = np.array([0, 7, 49], np.int32)
    jlp, jstate = jm.decode_logprobs(jp, jm.embed(jp, tokens), jenc.memory, jenc.state)
    tlp, tstate = tm.decode_logprobs(tp, tm.embed(tp, torch.from_numpy(tokens).long()),
                                     tenc.memory, tenc.state)
    assert tlp.dtype == torch.float32 and tlp.shape == (B, TINY["vocab_size"] + 1)
    _close(tlp, jlp)
    for a, b in zip(tstate, jstate):
        _close(a, b)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_port_init_has_the_jax_tree_layout(profile):
    """A random port init and a converted JAX init are the same tree, so
    check_params accepts each and rejects the other profiles' trees."""
    _, _, tm, tp = models(profile)
    check_params(tm, tp)
    own = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    check_params(tm, own)
    for other in sorted(set(PROFILES) - {profile}):
        with pytest.raises(ValueError):
            check_params(tm, models(other)[3])

