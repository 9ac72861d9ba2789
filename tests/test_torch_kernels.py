"""The additive-attention kernel's wrapper and plain version. Imports no
JAX, so the card's tests run here too:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest.py imports JAX, which the GPU machine
lacks.) The ``cuda`` tests skip without a CUDA device."""

import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.kernels import additive_attention as aa
from recurrent_fusion_network_torch.kernels import probe

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


def _kernel_inputs(G=1, N=4, A=6, D=20, dtype=torch.float32, device="cpu", h=H):
    g = torch.Generator(device=device).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)  # noqa: E731
    return [r(G * N, h), r(G * N, A, h), r(G, h), r(G), r(G * N, A, D)]


def _misaligned(t):
    """t's values in a contiguous view that starts one element into a flat
    buffer: not 16-byte aligned, yet contiguous, so the wrapper takes it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def test_kernel_plan_takes_several_rows_per_block_at_the_small_sites():
    """Stage II and the decoder (A = 8) get 4 rows per block, stage I one;
    every stage holds whole key and value rows in a multiple of 16 bytes,
    within the shared memory a block may opt in to."""
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.empty((), dtype=dtype).element_size()
        for A, D in ((196, 2048), (64, 1536), (49, 2208), (8, 512), (7, 21), (1, 64)):
            for backward in (False, True):
                R, stages, stage, smem = aa._plan(A, 512, D, dtype, backward)
                assert R == (4 if A <= 8 else 1)
                assert stage % 16 == 0 and stage >= max(512, D) * esize
                assert 2 <= stages <= 4 and smem <= aa.MAX_SHARED_BYTES
    # wide rows need every thread of the block: fewer rows per block
    assert aa._plan(8, 512, 4096, torch.float32, False)[0] == 1
    assert aa._plan(8, 2048, 64, torch.float32, True)[0] == 1


# f32 call sites of the SCST iteration (flagship widths, B = 256): stage I at
# N = B, the rollout's decoder at N = 2B, the step's decoder at N = B
SCST_SITES = [(196, 2048), (64, 1536), (64, 1280), (49, 2208), (8, 512)]


@pytest.mark.parametrize("A, D", SCST_SITES)
def test_kernel_plan_takes_the_vector_path_at_the_scst_sites(A, D):
    """The layout of each direction at the f32 SCST widths, and the 16-byte
    path for contiguous tensors (the row count N does not enter the plan;
    two rows stand for 256 or 512)."""
    for backward in (False, True):
        R, stages, stage, smem = aa._plan(A, 512, D, torch.float32, backward)
        assert R == (4 if A <= 8 else 1) and stages == 2
        assert stage % 16 == 0 and stage >= max(512, D) * 4 and smem <= aa.MAX_SHARED_BYTES
    _, keys, _, _, values = _kernel_inputs(N=2, A=A, D=D, h=512)
    assert aa._vec(512, D, keys, values) == 1


@pytest.mark.parametrize("case, vec", [("aligned", 1), ("odd_h", 0), ("odd_d", 0),
                                       ("misaligned_keys", 0), ("misaligned_values", 0)])
def test_kernel_takes_its_scalar_path_for_odd_widths_and_unaligned_inputs(case, vec):
    h, D = {"odd_h": (36, 64), "odd_d": (64, 36)}.get(case, (64, 64))
    _, keys, _, _, values = _kernel_inputs(A=3, D=D, dtype=torch.bfloat16, h=h)
    if case == "misaligned_keys":
        keys = _misaligned(keys)
    elif case == "misaligned_values":
        values = _misaligned(values)
    assert keys.is_contiguous() and values.is_contiguous()
    assert aa._vec(h, D, keys, values) == vec


@pytest.mark.parametrize("case", [
    "rank", "shape", "groups", "dtype", "mixed_dtype", "noncontiguous", "mask",
    "device", "empty", "shared_memory", "width",
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
    elif case == "shared_memory":  # q and v in f32 alone exceed a block's shared memory
        q, keys, v, bv, values = _kernel_inputs(N=1, A=1, D=4, h=30000)
    elif case == "width":  # more sums of z than a block's threads hold
        q, keys, v, bv, values = _kernel_inputs(N=1, A=1, D=4100)
    before = aa.launches
    with pytest.raises(err):
        aa.additive_attention(q, keys, v, bv, values, mask)
    assert aa.launches == before


# (G, N, A, H, D, keys and values misaligned): every branch of the kernel
FWD_SHAPES = {
    "stage2": (5, 64, 8, 32, 512, False),
    "group_boundary_in_a_block": (5, 63, 8, 512, 512, False),  # 315 rows, 4 per block
    "odd_widths": (1, 10, 7, 37, 21, False),                    # scalar path
    "one_position": (3, 5, 1, 64, 64, False),
    "stage1": (1, 6, 196, 512, 2048, False),
    "misaligned": (1, 5, 49, 512, 2208, True),                  # scalar path
    # SCST sites (B = 256): stage I at N = B, the decoder at 2B and at B
    "scst_stage1": (1, 256, 196, 512, 2048, False),
    "scst_stage1_enc3": (1, 256, 49, 512, 2208, False),
    "scst_rollout_decoder": (1, 512, 8, 512, 512, False),
    "scst_step_decoder": (1, 256, 8, 512, 512, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(FWD_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_the_card(cuda, dtype, shape):
    """The forward kernel vs its plain version, and twice on the same inputs
    bit for bit."""
    G, N, A, h, D, misaligned = FWD_SHAPES[shape]
    ins = _kernel_inputs(G=G, N=N, A=A, D=D, dtype=dtype, device="cuda", h=h)
    if misaligned:
        ins[1], ins[4] = _misaligned(ins[1]), _misaligned(ins[4])
    before, scalar = aa.launches, aa.scalar_launches
    z, w = aa.additive_attention(*ins)
    z2, w2 = aa.additive_attention(*ins)
    torch.cuda.synchronize()
    assert aa.launches == before + 2
    assert aa.scalar_launches - scalar == (2 if shape in ("odd_widths", "misaligned") else 0)
    assert torch.equal(z, z2) and torch.equal(w, w2)
    zr, wr = aa.additive_attention_ref(*ins)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=1.6e-2)
    torch.testing.assert_close(z.float(), zr.float(), **tol)
    torch.testing.assert_close(w.float(), wr.float(), **tol)


@pytest.mark.cuda
def test_masked_read_matches_plain_version_on_the_card(cuda):
    ins = _kernel_inputs(G=1, N=32, A=10, D=64, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    mask = torch.rand((32, 10), generator=g, device="cuda") > 0.4
    mask[0] = False  # a fully masked row: uniform weights, as softmax gives
    z, w = aa.additive_attention(*ins, mask)
    zr, wr = aa.additive_attention_ref(*ins, mask)
    torch.testing.assert_close(z, zr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(w, wr, rtol=1e-4, atol=1e-4)
    assert (w[1:][~mask[1:]] < 1e-6).all()
    torch.testing.assert_close(w[0], torch.full_like(w[0], 0.1))


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


def _bwd_inputs(G=1, N=4, A=6, D=20, dtype=torch.float32, device="cpu", masked=False,
                h=H):
    q, keys, v, bv, values = _kernel_inputs(G, N, A, D, dtype, device, h)
    g = torch.Generator(device=device).manual_seed(3)
    mask = None
    if masked:
        mask = torch.rand((G * N, A), generator=g, device=device) > 0.4
        mask[0] = False  # a fully masked row
    _, w = aa.additive_attention_ref(q, keys, v, bv, values, mask)
    dz = torch.randn(G * N, D, generator=g, device=device).to(dtype)
    return dz, None, q, keys, v, values, w, mask


@pytest.mark.parametrize("case", ["dz_shape", "dw_dtype", "w_noncontiguous", "device",
                                  "shared_memory", "width"])
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
    elif case == "shared_memory":  # one f32 row of dz and one value row exceed it
        dz, dw, q, keys, v, values, w, mask = _bwd_inputs(N=1, A=1, D=60000)
    elif case == "width":  # more sums of dq and dv than a block's threads hold
        dz, dw, q, keys, v, values, w, mask = _bwd_inputs(N=1, A=1, h=2052)
    before = aa.bwd_launches
    with pytest.raises(ValueError):
        aa.additive_attention_bwd(dz, dw, q, keys, v, values, w, mask)
    assert aa.bwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups, N, A, h, D, masked, need_dvalues, misaligned", [
    (5, 64, 8, 32, 512, False, True, False),
    (1, 64, 8, 32, 512, True, True, False),
    (1, 64, 8, 32, 512, False, False, False),
    (5, 63, 8, 512, 512, False, True, False),   # a group boundary inside a block
    (1, 10, 7, 37, 21, True, True, False),      # scalar path, a fully masked row
    (3, 5, 1, 64, 64, False, True, False),
    (1, 6, 196, 512, 2048, False, False, False),
    (1, 5, 49, 512, 2208, False, True, True),   # scalar path: unaligned keys, values
    (1, 256, 196, 512, 2048, False, False, False),  # SCST step, stage I
    (5, 256, 8, 512, 512, False, True, False),      # SCST step, stage II
    (1, 256, 8, 512, 512, False, True, False),      # SCST step, decoder
])
def test_backward_kernel_matches_plain_version_on_the_card(cuda, dtype, groups, N, A, h, D,
                                                           masked, need_dvalues, misaligned):
    """The backward kernel vs its plain version, and twice on the same
    inputs bit for bit (no float atomics)."""
    dz, _, q, keys, v, values, w, mask = _bwd_inputs(groups, N, A, D, dtype, "cuda",
                                                     masked, h)
    if misaligned:
        keys, values = _misaligned(keys), _misaligned(values)
    dw = torch.randn(w.shape, device="cuda").to(dtype) if groups == 5 else None
    before, scalar = aa.bwd_launches, aa.scalar_launches
    got = aa.additive_attention_bwd(dz, dw, q, keys, v, values, w, mask,
                                    need_dvalues=need_dvalues)
    again = aa.additive_attention_bwd(dz, dw, q, keys, v, values, w, mask,
                                      need_dvalues=need_dvalues)
    torch.cuda.synchronize()
    assert aa.bwd_launches == before + 2
    assert aa.scalar_launches - scalar == (2 if misaligned or h == 37 else 0)
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


@pytest.mark.parametrize("variant", sorted(probe.VARIANTS))
def test_probe_variants_apply_to_the_kernel_sources(variant, tmp_path):
    """Each variant of kernels/probe.py is a text edit that matches the
    sources exactly once, so the probe keeps measuring what it names."""
    _, edits, over = probe.VARIANTS[variant]
    root = probe.make_variant(variant, edits, dest=tmp_path)
    for fname, old, new in edits:
        text = (root / "csrc" / fname).read_text()
        assert old not in text or old in new
        assert new in text
    assert set(over) <= {"R", "stages", "stage_target", "vec"}

