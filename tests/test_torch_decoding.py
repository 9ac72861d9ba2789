"""Port decoding vs the JAX package's: greedy and beam-3 tokens of the whole
model through model_sample, and beam_search / sample on fixed log-prob
tables full of exact ties (the tie order of lax.top_k and argmax must
carry over). Tokens must be identical; log-probs agree to rtol 1e-4 /
atol 1e-5 (exactly, on the tables)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.decoding.api import model_sample as t_model_sample
from recurrent_fusion_network_torch.decoding.beam import beam_search as t_beam
from recurrent_fusion_network_torch.decoding.sample import sample as t_sample
from recurrent_fusion_network_tpu.decoding.api import model_sample as j_model_sample
from recurrent_fusion_network_tpu.decoding.beam import beam_search as j_beam
from recurrent_fusion_network_tpu.decoding.sample import sample as j_sample

from test_torch_model import features, models

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5


def _as_torch(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("beam_size", [1, 3])
@pytest.mark.parametrize("profile", ["tied", "untied"])
def test_model_sample_tokens_match_jax(profile, beam_size):
    jm, jp, tm, tp = models(profile)
    fcs, atts = features(seed=1, batch=4)
    jout = jax.jit(lambda p, f, a: j_model_sample(jm, p, f, a, beam_size=beam_size))(
        jp, fcs, atts)
    tout = t_model_sample(tm, tp, _as_torch(fcs), _as_torch(atts), beam_size=beam_size)
    np.testing.assert_array_equal(tout.seq.numpy(), np.asarray(jout.seq))
    np.testing.assert_allclose(tout.seq_logprobs.numpy(), np.asarray(jout.seq_logprobs),
                               rtol=RTOL, atol=ATOL)
    if beam_size > 1:
        np.testing.assert_array_equal(tout.top_seq.numpy(), np.asarray(jout.top_seq))
        np.testing.assert_allclose(tout.top_p.numpy(), np.asarray(jout.top_p),
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(tout.logprobs_all.numpy(),
                                   np.asarray(jout.logprobs_all), rtol=RTOL, atol=ATOL)


def _tied_table(seed, L, V):
    """(L+1, V, V) log-prob rows indexed by (step, previous token), built
    from integer logits in {0, 1, 2}: most rows hold exact ties."""
    rng = np.random.default_rng(seed)
    logits = rng.integers(0, 3, size=(L + 1, V, V)).astype(np.float32)
    logits[..., 0] -= 1.0  # EOS a little less likely, so beams run longer
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def _j_step(table):
    def step(tokens, carry):
        return table[carry[:, 0].astype(jnp.int32), tokens], carry + 1.0
    return step


def _t_step(table):
    table = torch.from_numpy(table.copy())

    def step(tokens, carry):
        return table[carry[:, 0].long(), tokens], carry + 1.0
    return step


@pytest.mark.parametrize("seed", range(6))
def test_beam_search_on_tied_tables_matches_jax(seed):
    B, K, L, V = 5, 3, 6, 7
    table = _tied_table(seed, L, V)
    carry = np.zeros((B, 1), np.float32)
    j = j_beam(_j_step(jnp.asarray(table)), jnp.asarray(carry), B, K, L, V)
    t = t_beam(_t_step(table), torch.from_numpy(carry), B, K, L, V)
    np.testing.assert_array_equal(t.top_seq.numpy(), np.asarray(j.top_seq))
    np.testing.assert_array_equal(t.seq.numpy(), np.asarray(j.seq))
    np.testing.assert_array_equal(t.top_p.numpy(), np.asarray(j.top_p))
    np.testing.assert_array_equal(t.seq_logprobs.numpy(), np.asarray(j.seq_logprobs))


@pytest.mark.parametrize("seed", range(4))
def test_greedy_sample_on_tied_tables_matches_jax(seed):
    B, L, V = 6, 6, 5
    table = _tied_table(100 + seed, L, V)
    carry = np.zeros((B, 1), np.float32)
    j = j_sample(_j_step(jnp.asarray(table)), jnp.asarray(carry), B, L, V)
    t = t_sample(_t_step(table), torch.from_numpy(carry), B, L, V)
    np.testing.assert_array_equal(t.seq.numpy(), np.asarray(j.seq))
    np.testing.assert_array_equal(t.seq_logprobs.numpy(), np.asarray(j.seq_logprobs))
    np.testing.assert_array_equal(t.logprobs_all.numpy(), np.asarray(j.logprobs_all))
    # a greedy_mask of all-True rows is the greedy decode, whatever is drawn
    tm = t_sample(_t_step(table), torch.from_numpy(carry), B, L, V,
                  greedy_mask=torch.ones(B, dtype=torch.bool),
                  generator=torch.Generator().manual_seed(seed))
    np.testing.assert_array_equal(tm.seq.numpy(), t.seq.numpy())


def test_temperature_sampling_draws_from_the_generator():
    """Categorical rows are reproducible from the torch.Generator's seed and
    keep the reference's record semantics (zeros after EOS)."""
    B, L, V = 8, 6, 5
    table = _tied_table(7, L, V)
    carry = torch.zeros((B, 1))
    runs = [t_sample(_t_step(table), carry, B, L, V, sample_max=False, temperature=0.7,
                     generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    assert torch.equal(runs[0].seq, runs[1].seq)
    assert not torch.equal(runs[0].seq, runs[2].seq)
    for out in runs:
        seq = out.seq.numpy()
        for row in seq:
            eos = np.nonzero(row == 0)[0]
            if len(eos):
                assert not row[eos[0]:].any()
