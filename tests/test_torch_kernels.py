"""The additive-attention kernel's wrapper and plain version. Imports no
JAX, so the card's tests run here too:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest.py imports JAX, which the GPU machine
lacks.) The ``cuda`` tests skip without a CUDA device."""

import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.kernels import additive_attention as aa

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
H = 32


def _feats(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("groups", [1, 3])
def test_additive_attention_ref_matches_port_attend(groups):
    """The kernel's plain version, called as the kernel is called, equals
    attend's own score/softmax/context math written out."""
    rng = np.random.default_rng(2)
    N, A, D = 4, 6, 20
    q = torch.from_numpy(_feats(rng, groups * N, H))
    keys = torch.from_numpy(_feats(rng, groups * N, A, H))
    v = torch.from_numpy(_feats(rng, groups, H))
    bv = torch.from_numpy(_feats(rng, groups))
    values = torch.from_numpy(_feats(rng, groups * N, A, D))
    z, w = aa.additive_attention_ref(q, keys, v, bv, values)
    g = torch.arange(groups * N) // N
    s = (torch.tanh(keys + q[:, None, :]) * v[g][:, None, :]).sum(-1) + bv[g][:, None]
    w_ref = torch.softmax(s, dim=-1)
    torch.testing.assert_close(w, w_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(z, (w_ref[:, :, None] * values).sum(1), rtol=RTOL, atol=ATOL)
    # the wrapper on CPU tensors is the plain version
    zw, ww = aa.additive_attention(q, keys, v, bv, values)
    torch.testing.assert_close(zw, z, rtol=0, atol=0)
    torch.testing.assert_close(ww, w, rtol=0, atol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _kernel_inputs(G=1, N=4, A=6, D=20, dtype=torch.float32, device="cpu"):
    g = torch.Generator(device=device).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)  # noqa: E731
    return [r(G * N, H), r(G * N, A, H), r(G, H), r(G), r(G * N, A, D)]


@pytest.mark.parametrize("case", [
    "rank", "shape", "groups", "dtype", "mixed_dtype", "noncontiguous", "mask",
    "device", "empty",
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, keys, v, bv, values = _kernel_inputs(G=2)
    mask = None
    err = ValueError
    if case == "rank":
        q = q[None]
    elif case == "shape":
        values = values[:, :-1].contiguous()
    elif case == "groups":
        v, bv = _kernel_inputs(G=3)[2:4]
    elif case == "dtype":
        q, keys, v, bv, values = (x.double() for x in (q, keys, v, bv, values))
        err = TypeError
    elif case == "mixed_dtype":
        keys = keys.to(torch.bfloat16)
        err = TypeError
    elif case == "noncontiguous":
        values = values.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "mask":
        mask = torch.ones(keys.shape[:2], dtype=torch.uint8)
    elif case == "device":
        q, keys, v, bv, values = (x.to("meta") for x in (q, keys, v, bv, values))
    elif case == "empty":
        q, keys, values = q[:0], keys[:0], values[:0]
    before = aa.launches
    with pytest.raises(err):
        aa.additive_attention(q, keys, v, bv, values, mask)
    assert aa.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_the_card(cuda, dtype):
    ins = _kernel_inputs(G=5, N=64, A=8, D=512, dtype=dtype, device="cuda")
    before = aa.launches
    z, w = aa.additive_attention(*ins)
    torch.cuda.synchronize()
    assert aa.launches == before + 1
    zr, wr = aa.additive_attention_ref(*ins)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=1.6e-2)
    torch.testing.assert_close(z.float(), zr.float(), **tol)
    torch.testing.assert_close(w.float(), wr.float(), **tol)


@pytest.mark.cuda
def test_masked_read_matches_plain_version_on_the_card(cuda):
    ins = _kernel_inputs(G=1, N=32, A=10, D=64, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    mask = torch.rand((32, 10), generator=g, device="cuda") > 0.4
    z, w = aa.additive_attention(*ins, mask)
    zr, wr = aa.additive_attention_ref(*ins, mask)
    torch.testing.assert_close(z, zr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(w, wr, rtol=1e-4, atol=1e-4)
    assert (w[~mask] < 1e-6).all()


@pytest.mark.cuda
def test_model_decode_goes_through_the_kernel_on_the_card(cuda):
    """A tiny RFNet beam-3 decode on the card queues without a host sync,
    launches the kernel for every attention read (M*R0 + S + L of them), and
    gives the tokens of the same decode with the plain version patched in."""
    from unittest import mock

    from recurrent_fusion_network_torch.decoding.api import model_sample
    from recurrent_fusion_network_torch.models import RecurrentFusionModel
    from recurrent_fusion_network_torch.ops import attention

    model = RecurrentFusionModel(
        vocab_size=50, seq_length=6, fc_feat_sizes=(24, 16), att_feat_sizes=(40, 24),
        att_nums=(7, 5), input_encoding_size=32, rnn_size=32, att_hid_size=32,
        num_review_steps=2, num_review_steps_0=3, top_words_count=30,
        tied_att_keys=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(g, device="cuda")
    fcs = [torch.randn(4, d, generator=g, device="cuda") for d in model.fc_feat_sizes]
    atts = [torch.randn(4, a, d, generator=g, device="cuda")
            for a, d in zip(model.att_nums, model.att_feat_sizes)]
    before = aa.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the decode never waits on the device
    try:
        out = model_sample(model, params, fcs, atts, beam_size=3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert aa.launches - before == 2 * 3 + 2 + 6
    with mock.patch.object(attention, "additive_attention", aa.additive_attention_ref):
        plain = model_sample(model, params, fcs, atts, beam_size=3)
    assert torch.equal(out.top_seq, plain.top_seq)
    torch.testing.assert_close(out.top_p, plain.top_p, rtol=1e-4, atol=1e-4)


def _bwd_inputs(G=1, N=4, A=6, D=20, dtype=torch.float32, device="cpu", masked=False):
    q, keys, v, bv, values = _kernel_inputs(G, N, A, D, dtype, device)
    g = torch.Generator(device=device).manual_seed(3)
    mask = None
    if masked:
        mask = torch.rand((G * N, A), generator=g, device=device) > 0.4
        mask[0] = False  # a fully masked row
    _, w = aa.additive_attention_ref(q, keys, v, bv, values, mask)
    dz = torch.randn(G * N, D, generator=g, device=device).to(dtype)
    return dz, None, q, keys, v, values, w, mask


@pytest.mark.parametrize("case", ["dz_shape", "dw_dtype", "w_noncontiguous", "device"])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(case):
    dz, dw, q, keys, v, values, w, mask = _bwd_inputs(G=2)
    if case == "dz_shape":
        dz = dz[:, :-1].contiguous()
    elif case == "dw_dtype":
        dw = torch.zeros(w.shape, dtype=torch.float64)
    elif case == "w_noncontiguous":
        w = w.t().contiguous().t()
    elif case == "device":
        dz, q, keys, v, values, w = (x.to("meta") for x in (dz, q, keys, v, values, w))
    before = aa.bwd_launches
    with pytest.raises(ValueError):
        aa.additive_attention_bwd(dz, dw, q, keys, v, values, w, mask)
    assert aa.bwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups, masked, need_dvalues",
                         [(5, False, True), (1, True, True), (1, False, False)])
def test_backward_kernel_matches_plain_version_on_the_card(cuda, dtype, groups, masked,
                                                           need_dvalues):
    """The backward kernel vs its plain version, and twice on the same
    inputs bit for bit (no float atomics)."""
    dz, _, q, keys, v, values, w, mask = _bwd_inputs(groups, 64, 8, 512, dtype, "cuda",
                                                     masked)
    dw = torch.randn(w.shape, device="cuda").to(dtype) if groups == 5 else None
    before = aa.bwd_launches
    got = aa.additive_attention_bwd(dz, dw, q, keys, v, values, w, mask,
                                    need_dvalues=need_dvalues)
    again = aa.additive_attention_bwd(dz, dw, q, keys, v, values, w, mask,
                                      need_dvalues=need_dvalues)
    torch.cuda.synchronize()
    assert aa.bwd_launches == before + 2
    ref = aa.additive_attention_bwd_ref(dz, dw, q, keys, v, values, w, mask,
                                        need_dvalues=need_dvalues)
    assert (got[2] is None) == (not need_dvalues)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for i, (a, b, c) in enumerate(zip(got, again, ref)):
        if c is None:
            continue
        assert torch.equal(a, b)
        scale = max(c.float().abs().max().item(), ref[3].float().abs().max().item()
                    if i == 4 else 0.0)
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol * scale)


@pytest.mark.cuda
def test_train_step_goes_through_both_kernels_on_the_card(cuda):
    """A tiny RFNet train step on the card launches each kernel once per
    attention read (M*R0 + S + L+1), gives finite non-zero grads to every
    leaf but the score biases (whose true gradient is 0), and the grads of
    the same step with the plain versions patched in."""
    from unittest import mock

    from recurrent_fusion_network_torch.config import Options
    from recurrent_fusion_network_torch.models import RecurrentFusionModel
    from recurrent_fusion_network_torch.ops import attention
    from recurrent_fusion_network_torch.ops.initializers import tree_leaves, tree_map
    from recurrent_fusion_network_torch.training.criterion import make_criterion
    from recurrent_fusion_network_torch.training.train_loop import make_train_step

    model = RecurrentFusionModel(
        vocab_size=50, seq_length=6, fc_feat_sizes=(24, 16), att_feat_sizes=(40, 24),
        att_nums=(7, 5), input_encoding_size=32, rnn_size=32, att_hid_size=32,
        num_review_steps=2, num_review_steps_0=3, top_words_count=30,
        tied_att_keys=True)
    opt = Options(caption_model="recurrent_fusion_model", seq_length=6,
                  feat_array_info=[])
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(g, device="cuda")
    B = 4
    fcs = [torch.randn(B, d, generator=g, device="cuda") for d in model.fc_feat_sizes]
    atts = [torch.randn(B, a, d, generator=g, device="cuda")
            for a, d in zip(model.att_nums, model.att_feat_sizes)]
    labels = torch.randint(1, 51, (B, 8), generator=g, device="cuda")
    labels[:, 0] = 0
    masks = torch.ones(B, 8, device="cuda")
    top = torch.full((B, 30), -1, dtype=torch.long, device="cuda")
    top[:, :3] = torch.arange(3, device="cuda")

    class Keep:
        """An optimizer that keeps the grads and leaves the params."""

        def update(self, grads, state, p):
            self.grads = grads
            return tree_map(torch.zeros_like, grads), state

    grads = {}
    for path in ("kernel", "plain"):
        keep = Keep()
        step = make_train_step(model, make_criterion(opt), keep)
        fn = aa.additive_attention if path == "kernel" else aa.additive_attention_ref
        before = (aa.launches, aa.bwd_launches)
        with mock.patch.object(attention, "additive_attention", fn):
            step(params, None, fcs, atts, labels, masks, top, 0.0, 0.0, None)
        torch.cuda.synchronize()
        used = (aa.launches - before[0], aa.bwd_launches - before[1])
        assert used == ((2 * 3 + 2 + 7,) * 2 if path == "kernel" else (0, 0))
        grads[path] = keep.grads
    leaves = tree_leaves(grads["kernel"])
    bias = [g for p, g in zip(_paths(grads["kernel"]), leaves) if "att_h_2_out" in p
            and p.endswith("'b']")]
    assert len(bias) == 4
    for p, gk, gp in zip(_paths(grads["kernel"]), leaves, tree_leaves(grads["plain"])):
        assert torch.isfinite(gk).all(), p
        if not ("att_h_2_out" in p and p.endswith("'b']")):
            assert (gk != 0).any(), p
            torch.testing.assert_close(gk, gp, rtol=1e-3, atol=1e-5)


def _paths(tree, path=""):
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _paths(v, f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in _paths(v, f"{path}[{i}]")]
    return [path]
