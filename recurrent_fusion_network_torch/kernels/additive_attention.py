"""additive_attention_fwd: the additive-attention read as one CUDA kernel.

Replaces on the TPU side ``recurrent_fusion_network_tpu/ops/attention.py::
attend`` (XLA-fused jnp) and the attention half of the deleted Pallas kernel
``ops/pallas_kernels.py::fused_att_lstm_step``. The kernel source,
``csrc/additive_attention.cu``, notes what bounds it (bytes of keys and
values) and what its design does about that.

For row n of head group g = n // N, with rows = G * N:
  s[n, a] = sum_h tanh(keys[n, a, h] + q[n, h]) * v[g, h] + bv[g]
  w[n, :] = softmax_a(s[n, :])     (s = NEG_INF where an optional mask is 0)
  z[n, :] = sum_a w[n, a] * values[n, a, :]

Stage II of the RFNet encoder passes its M heads as G groups in one launch;
stage I and the decoder pass G = 1.

``additive_attention`` takes f32 or bf16, accumulates in f32 and returns
z and w in the input dtype. On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs ``additive_attention_ref``, the plain
PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e9
MAX_SHARED_BYTES = 48 * 1024  # static launch limit (no opt-in attribute set)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (chip_smoke.py resets and reads it to
# show that the main path went through the kernel). CPU calls do not count.
launches = 0


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
    ts = (q, keys, v, bv, values)
    if q.dim() != 2 or keys.dim() != 3 or v.dim() != 2 or bv.dim() != 1 \
            or values.dim() != 3:
        raise ValueError(
            "additive_attention expects q (rows, H), keys (rows, A, H), "
            "v (G, H), bv (G,), values (rows, A, D); got ranks "
            f"{[t.dim() for t in ts]}")
    rows, A, H = keys.shape
    G = v.shape[0]
    D = values.shape[2]
    if q.shape != (rows, H) or v.shape != (G, H) or bv.shape != (G,) \
            or values.shape[:2] != (rows, A):
        raise ValueError(
            f"additive_attention shape mismatch: q {tuple(q.shape)}, keys "
            f"{tuple(keys.shape)}, v {tuple(v.shape)}, bv {tuple(bv.shape)}, "
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


def _launcher():
    """The C entry point of csrc/additive_attention.cu (built on first use)."""
    from .build import load

    fn = load("additive_attention").additive_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def additive_attention(q, keys, v, bv, values, mask=None):
    """-> (z (rows, D), w (rows, A)); see the module docstring."""
    global launches
    rows, A, H, D, G = _check(q, keys, v, bv, values, mask)
    if q.device.type == "cpu":
        return additive_attention_ref(q, keys, v, bv, values, mask)
    if q.device.type != "cuda":
        raise ValueError(f"additive_attention has no kernel for {q.device}")
    if (2 * H + A) * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"additive_attention: H={H}, A={A} need more shared memory than "
            f"the kernel's {MAX_SHARED_BYTES} bytes")
    fn = _launcher()
    z = torch.empty((rows, D), dtype=q.dtype, device=q.device)
    w = torch.empty((rows, A), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), keys.data_ptr(), v.data_ptr(), bv.data_ptr(),
                 values.data_ptr(), None if mask is None else mask.data_ptr(),
                 z.data_ptr(), w.data_ptr(), rows, rows // G, A, H, D,
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"additive_attention_fwd launch failed: CUDA error {err}")
    launches += 1
    return z, w
