"""The additive-attention read and its gradient as two CUDA kernels.

``additive_attention_fwd`` (``csrc/additive_attention.cu``) replaces on the
TPU side ``recurrent_fusion_network_tpu/ops/attention.py::attend``
(XLA-fused jnp) and the attention half of the deleted Pallas kernel
``ops/pallas_kernels.py::fused_att_lstm_step``; ``additive_attention_bwd``
(``csrc/additive_attention_bwd.cu``) replaces the gradient XLA derives for
``attend`` in the XE train step. Each source notes what bounds it (bytes of
keys and values) and what its design does about that.

For row n of head group g = n // N, with rows = G * N:
  s[n, a] = sum_h tanh(keys[n, a, h] + q[n, h]) * v[g, h] + bv[g]
  w[n, :] = softmax_a(s[n, :])     (s = NEG_INF where an optional mask is 0)
  z[n, :] = sum_a w[n, a] * values[n, a, :]

Stage II of the RFNet encoder passes its M heads as G groups in one launch;
stage I and the decoder pass G = 1.

``additive_attention`` is differentiable on every device through
``AdditiveAttentionFn``. It takes f32 or bf16, accumulates in f32 and
returns z and w (and, backward, every gradient) in the input dtype. On a
CUDA tensor each direction launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch version of the same function,
``additive_attention_ref`` forward and ``additive_attention_bwd_ref``
backward (explicit equations, not autograd).

Under activation rematerialisation with the ``save_ctx`` policy
(``models/base.py::remat_wrap``) the reads of a checkpointed step keep
their outputs: ``recording(tape)`` appends each read's (z, w) to ``tape``
during the step's forward, and ``replaying(tape)`` hands them back, in the
same order, during autograd's recompute, which then launches no forward
kernel. The backward is the same either way.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

NEG_INF = -1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The kernels' launch layout (csrc/common.cuh): 256 consumer threads and one
# producer warp per block; R rows per block, each a team of 256 / R threads
# with its own ring of stages; dynamic shared memory up to what an sm_90
# block may opt in to.
CONSUMER_THREADS = 256
MAX_SHARED_BYTES = 227 * 1024
_RING_HEADER = 512  # the ring's mbarriers (common.cuh kRingHeader)
_FWD_ACC, _BWD_ACC = 16, 8  # f32 sums per thread: of z (fwd), of dq and dv (bwd)

# Kernel launches since the last reset (chip_smoke.py resets and reads them
# to show that the main path went through the kernels). CPU calls do not
# count. ``launches`` counts additive_attention_fwd, ``bwd_launches``
# additive_attention_bwd; ``scalar_launches`` counts the launches of either
# that took the kernels' scalar path (odd widths, unaligned keys or values).
launches = 0
bwd_launches = 0
scalar_launches = 0

_tape = threading.local()  # mode: None, "record" or "replay"; outs; pos


def _pad(x, n):
    return -(-x // n) * n


def _plan(A, H, D, dtype, backward):
    """The launch layout the kernels take for these widths: -> (rows per
    block R, stages per row, stage bytes, dynamic shared bytes). R = 4 rows
    per block when A <= 8 (fewer if a row's threads cannot hold its sums);
    two stages per row of about 16 KB (R = 1) or 4 KB, holding whole key or
    value rows. Raises ValueError for widths no layout takes: the forward
    keeps up to 16 f32 sums of z per thread (D <= 4096), the backward up to
    8 of dq and of dv (H <= 2048), and a block holds at most
    MAX_SHARED_BYTES. The same on every device, so the plain version takes
    what the kernel takes."""
    esize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // esize
    row = max(H, D) * esize
    groups, acc = (-(-H // vec), _BWD_ACC) if backward else (-(-D // vec), _FWD_ACC)
    team_floats = (_pad(D, 8) + 2 * _pad(H, 8) + 2 * _pad(A, 4) + 8 if backward
                   else 2 * _pad(H, 8) + _pad(A, 4) + 8)
    stages = 2
    for R in ((4, 2, 1) if A <= 8 else (1,)):
        threads = CONSUMER_THREADS // R
        if -(-groups // threads) > acc // vec:
            continue
        per_stage = max(1, ((16384 if R == 1 else 4096) + row // 2) // row)
        stage = -(-per_stage * row // 16) * 16
        if backward:  # the keys pass's last reduction reuses a row's stages
            stage = max(stage, -(-2 * threads * vec * 4 // (16 * stages)) * 16)
        smem = _RING_HEADER + R * (stages * stage + 4 * team_floats)
        if smem <= MAX_SHARED_BYTES:
            return R, stages, stage, smem
    what = "D <= 4096" if not backward else "H <= 2048"
    raise ValueError(
        f"additive_attention{'_bwd' if backward else ''}: no kernel layout for A={A}, "
        f"H={H}, D={D} in {dtype}: the kernel takes {what} and at most "
        f"{MAX_SHARED_BYTES} bytes of shared memory per block")


def _vec(H, D, keys, values):
    """1 when the kernels can stream keys and values with 16-byte bulk copies
    (widths a multiple of 16 bytes, both tensors 16-byte aligned), else 0:
    the kernels' scalar path."""
    n = 16 // keys.element_size()
    return int(H % n == 0 and D % n == 0 and keys.data_ptr() % 16 == 0
               and values.data_ptr() % 16 == 0)


def additive_attention_ref(q, keys, v, bv, values, mask=None):
    """Plain PyTorch version: the same function, f32 accumulation, outputs in
    the input dtype. mask: optional (rows, A) bool."""
    G = v.shape[0]
    rows, A, H = keys.shape
    N = rows // G
    dt = values.dtype
    q32, k32, v32, b32, x32 = (t.float() for t in (q, keys, v, bv, values))
    e = torch.tanh(k32.view(G, N, A, H) + q32.view(G, N, 1, H))
    s = (torch.einsum("gnah,gh->gna", e, v32) + b32[:, None, None]).reshape(rows, A)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    z = torch.einsum("na,nad->nd", w, x32)
    return z.to(dt), w.to(dt)


def _check(q, keys, v, bv, values, mask):
    """Validate the read's inputs (bv None: the backward, which needs none);
    -> (rows, A, H, D, G)."""
    ts = tuple(t for t in (q, keys, v, bv, values) if t is not None)
    if q.dim() != 2 or keys.dim() != 3 or v.dim() != 2 or values.dim() != 3 \
            or (bv is not None and bv.dim() != 1):
        raise ValueError(
            "additive_attention expects q (rows, H), keys (rows, A, H), "
            "v (G, H), bv (G,), values (rows, A, D); got ranks "
            f"{[t.dim() for t in ts]}")
    rows, A, H = keys.shape
    G = v.shape[0]
    D = values.shape[2]
    if q.shape != (rows, H) or v.shape != (G, H) or values.shape[:2] != (rows, A) \
            or (bv is not None and bv.shape != (G,)):
        raise ValueError(
            f"additive_attention shape mismatch: q {tuple(q.shape)}, keys "
            f"{tuple(keys.shape)}, v {tuple(v.shape)}, "
            f"bv {None if bv is None else tuple(bv.shape)}, "
            f"values {tuple(values.shape)}")
    if min(rows, A, H, D, G) < 1 or rows % G:
        raise ValueError(
            f"additive_attention needs non-empty dims and rows ({rows}) "
            f"divisible by the head groups ({G})")
    if mask is not None and (mask.shape != (rows, A) or mask.dtype != torch.bool):
        raise ValueError(
            f"mask must be a ({rows}, {A}) bool tensor, got "
            f"{tuple(mask.shape)} {mask.dtype}")
    dt = q.dtype
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in ts):
        raise TypeError(
            "additive_attention takes float32 or bfloat16, one dtype for all "
            f"inputs; got {[t.dtype for t in ts]}")
    dev = q.device
    if any(t.device != dev for t in ts) or (mask is not None and mask.device != dev):
        raise ValueError("additive_attention inputs lie on different devices")
    if not all(t.is_contiguous() for t in ts) or (
            mask is not None and not mask.is_contiguous()):
        raise ValueError("additive_attention inputs must be contiguous")
    return rows, A, H, D, G


def additive_attention_bwd_ref(dz, dw, q, keys, v, values, w, mask=None, *,
                               need_dvalues=True):
    """Plain PyTorch version of the gradient, written out (not autograd):
    -> (dq, dkeys, dvalues or None, dv, dbv), f32 accumulation, outputs in
    the input dtype. dw (the incoming grad of w) may be None."""
    G = v.shape[0]
    rows, A, H = keys.shape
    N = rows // G
    dt = keys.dtype
    dz32, q32, k32, v32, x32, w32 = (t.float() for t in (dz, q, keys, v, values, w))
    dw32 = torch.einsum("nd,nad->na", dz32, x32)
    if dw is not None:
        dw32 = dw32 + dw.float()
    ds = w32 * (dw32 - (w32 * dw32).sum(-1, keepdim=True))
    if mask is not None:
        ds = torch.where(mask, ds, torch.zeros_like(ds))
    e = torch.tanh(k32.view(G, N, A, H) + q32.view(G, N, 1, H))
    ds_g = ds.view(G, N, A)
    dpre = ds_g[..., None] * v32.view(G, 1, 1, H) * (1 - e * e)
    dq = dpre.sum(2).reshape(rows, H)
    dv = torch.einsum("gna,gnah->gh", ds_g, e)
    dbv = ds_g.sum((1, 2))
    dvalues = torch.einsum("na,nd->nad", w32, dz32).to(dt) if need_dvalues else None
    return dq.to(dt), dpre.reshape(rows, A, H).to(dt), dvalues, dv.to(dt), dbv.to(dt)


def _launcher(source: str, symbol: str, n_ptrs: int):
    """The C entry point ``symbol`` of csrc/<source>.cu (built on first use)."""
    from .build import load

    fn = getattr(load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _cuda_device(t, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what} has no kernel for {t.device}")


def additive_attention_fwd(q, keys, v, bv, values, mask=None):
    """-> (z (rows, D), w (rows, A)), no autograd: the forward kernel on a
    CUDA tensor, ``additive_attention_ref`` on a CPU tensor."""
    global launches, scalar_launches
    rows, A, H, D, G = _check(q, keys, v, bv, values, mask)
    plan = _plan(A, H, D, q.dtype, backward=False)
    if q.device.type == "cpu":
        return additive_attention_ref(q, keys, v, bv, values, mask)
    _cuda_device(q, "additive_attention_fwd")
    fn = _launcher("additive_attention", "additive_attention_fwd", 8)
    z = torch.empty((rows, D), dtype=q.dtype, device=q.device)
    w = torch.empty((rows, A), dtype=q.dtype, device=q.device)
    vec = _vec(H, D, keys, values)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), keys.data_ptr(), v.data_ptr(), bv.data_ptr(),
                 values.data_ptr(), _ptr(mask), z.data_ptr(), w.data_ptr(),
                 rows, rows // G, A, H, D, _DTYPE_CODES[q.dtype], vec, *plan, stream)
    if err != 0:
        raise RuntimeError(f"additive_attention_fwd launch failed: CUDA error {err}")
    launches += 1
    scalar_launches += 1 - vec
    return z, w


def additive_attention_bwd(dz, dw, q, keys, v, values, w, mask=None, *,
                           need_dvalues=True):
    """-> (dq, dkeys, dvalues or None, dv, dbv): the backward kernel on a
    CUDA tensor, ``additive_attention_bwd_ref`` on a CPU tensor. dz (rows,
    D) and w (rows, A) as the forward gave them; dw may be None."""
    global bwd_launches, scalar_launches
    rows, A, H, D, G = _check(q, keys, v, None, values, mask)
    for name, t, shape in (("dz", dz, (rows, D)), ("w", w, (rows, A)),
                           ("dw", dw, (rows, A))):
        if t is None and name == "dw":
            continue
        if tuple(t.shape) != shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(
                f"additive_attention_bwd: {name} must be a contiguous {shape} "
                f"{q.dtype} tensor on {q.device}, got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")
    plan = _plan(A, H, D, q.dtype, backward=True)
    if q.device.type == "cpu":
        return additive_attention_bwd_ref(dz, dw, q, keys, v, values, w, mask,
                                          need_dvalues=need_dvalues)
    _cuda_device(q, "additive_attention_bwd")
    fn = _launcher("additive_attention_bwd", "additive_attention_bwd", 15)
    new = lambda *shape, dtype=q.dtype: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=q.device)
    dq, dkeys, dv, dbv = new(rows, H), new(rows, A, H), new(G, H), new(G)
    dvalues = new(rows, A, D) if need_dvalues else None
    dv_part = new(rows, H, dtype=torch.float32)
    dbv_part = new(rows, dtype=torch.float32)
    vec = _vec(H, D, keys, values)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(dz.data_ptr(), _ptr(dw), q.data_ptr(), keys.data_ptr(), v.data_ptr(),
                 values.data_ptr(), w.data_ptr(), _ptr(mask), dq.data_ptr(),
                 dkeys.data_ptr(), _ptr(dvalues), dv.data_ptr(), dbv.data_ptr(),
                 dv_part.data_ptr(), dbv_part.data_ptr(), rows, rows // G, A, H, D,
                 _DTYPE_CODES[q.dtype], vec, *plan, stream)
    if err != 0:
        raise RuntimeError(f"additive_attention_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    scalar_launches += 1 - vec
    return dq, dkeys, dvalues, dv, dbv


class AdditiveAttentionFn(torch.autograd.Function):
    """Autograd for the read: forward through ``additive_attention_fwd``,
    or ``replay``'s (z, w) where they were kept; backward through
    ``additive_attention_bwd``. Saves the inputs the gradient needs and w;
    the tanh activations are recomputed backward."""

    @staticmethod
    def forward(ctx, q, keys, v, bv, values, mask, replay=None):
        if replay is None:
            z, w = additive_attention_fwd(q, keys, v, bv, values, mask)
        else:  # new tensors over the kept storage, no copy
            z, w = replay[0].detach(), replay[1].detach()
        ctx.save_for_backward(q, keys, v, values, w, mask)
        ctx.set_materialize_grads(False)  # the cells discard w: its grad is None
        return z, w

    @staticmethod
    def backward(ctx, dz, dw):
        q, keys, v, values, w, mask = ctx.saved_tensors
        if dz is None:
            dz = torch.zeros((keys.shape[0], values.shape[2]), dtype=q.dtype,
                             device=q.device)
        dq, dkeys, dvalues, dv, dbv = additive_attention_bwd(
            dz.contiguous(), None if dw is None else dw.contiguous(), q, keys, v,
            values, w, mask, need_dvalues=ctx.needs_input_grad[4])
        return dq, dkeys, dv, dbv, dvalues, None, None


@contextlib.contextmanager
def recording(tape: list):
    """Append every read's (z, w), detached, to ``tape`` (the first forward
    of a step checkpointed under the save_ctx policy)."""
    prev = getattr(_tape, "mode", None), getattr(_tape, "outs", None)
    _tape.mode, _tape.outs = "record", tape
    try:
        yield
    finally:
        _tape.mode, _tape.outs = prev


@contextlib.contextmanager
def replaying(tape: list):
    """Return the reads' (z, w) from ``tape``, in order, instead of
    launching the forward (the recompute of that step)."""
    prev = (getattr(_tape, "mode", None), getattr(_tape, "outs", None),
            getattr(_tape, "pos", 0))
    _tape.mode, _tape.outs, _tape.pos = "replay", tape, 0
    try:
        yield
    finally:
        _tape.mode, _tape.outs, _tape.pos = prev


def additive_attention(q, keys, v, bv, values, mask=None):
    """-> (z (rows, D), w (rows, A)), differentiable; see the module
    docstring."""
    _check(q, keys, v, bv, values, mask)
    mode = getattr(_tape, "mode", None)
    if mode == "replay":
        replay = _tape.outs[_tape.pos]
        _tape.pos += 1
        if replay[0].shape != (keys.shape[0], values.shape[2]):
            raise RuntimeError("additive_attention: the recompute's reads differ from "
                               "the forward's")
        return AdditiveAttentionFn.apply(q, keys, v, bv, values, mask, replay)
    z, w = AdditiveAttentionFn.apply(q, keys, v, bv, values, mask)
    if mode == "record":
        _tape.outs.append((z.detach(), w.detach()))
    return z, w
