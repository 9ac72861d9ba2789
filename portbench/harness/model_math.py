"""Operations and bytes from the configuration's widths, for what these
inputs need. The benchmark's own account: nothing here reads the program.

Attention reads (the kernels of ``kernels/additive_attention.py``): each
call is (rows, A, H, D, G, backward-needs-dvalues). Bytes count each input
read once and each output written once: forward q, keys, v, bv, values in,
z and w out; backward dz, q, keys, v, values, w in, dq, dkeys, dv, dbv (and
dvalues where the values take a gradient) out. The backward's f32
partial sums are the kernels' own scratch and are not counted.

FLOPs count the matrix products (2 m n k) of the forward; a training step
is three forwards (the backward twice the forward's).
"""

from __future__ import annotations

PEAKS = {  # one NVIDIA H100 SXM, NVIDIA's data sheet, dense
    "hbm_bytes_per_s": 3.35e12,
    "float32": 67e12,      # IEEE f32, outside the tensor cores
    "bfloat16": 989e12,
}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def _enc(cfg):
    return [(e["fc_feat_size"], e["att_num"], e["att_feat_size"]) for e in cfg["encoders"]]


def attention_calls(cfg, enc_rows: int, dec_rows: int, dec_steps: int):
    """The reads of one forward: [(rows, A, H, D, G, values_need_grad)]."""
    Hd, R = cfg["att_hid_size"], cfg["rnn_size"]
    calls = []
    if cfg["model"] == "recurrent_fusion_model":
        M, S0 = len(cfg["encoders"]), cfg["num_review_steps_0"]
        for _ in range(S0):
            calls += [(enc_rows, A, Hd, D, 1, False) for _, A, D in _enc(cfg)]
        calls += [(M * enc_rows, S0, Hd, R, M, True)] * cfg["num_review_steps"]
    else:
        (_, A, D), = _enc(cfg)
        calls += [(enc_rows, A, Hd, D, 1, False)] * cfg["num_review_steps"]
    calls += [(dec_rows, cfg["num_review_steps"], Hd, R, 1, True)] * dec_steps
    return calls


def fwd_bytes(call, e: int) -> int:
    rows, A, H, D, G, _ = call
    return e * (rows * H + rows * A * H + G * H + G + rows * A * D + rows * D + rows * A)


def bwd_bytes(call, e: int) -> int:
    rows, A, H, D, G, need_dvalues = call
    reads = rows * D + rows * H + rows * A * H + G * H + rows * A * D + rows * A
    writes = rows * H + rows * A * H + G * H + G + (rows * A * D if need_dvalues else 0)
    return e * (reads + writes)


def forward_flops(cfg, enc_rows: int, dec_rows: int, dec_steps: int) -> float:
    """Matrix-product FLOPs of one forward: the encoder over ``enc_rows``,
    the decoder ``dec_steps`` steps over ``dec_rows`` lanes."""
    R, E, Hd, C = cfg["rnn_size"], cfg["input_encoding_size"], cfg["att_hid_size"], \
        cfg["top_words_count"]
    V1 = cfg["vocab_size"] + 1
    S = cfg["num_review_steps"]
    enc = 0
    if cfg["model"] == "recurrent_fusion_model":
        M, S0 = len(cfg["encoders"]), cfg["num_review_steps_0"]
        for fc, A, D in _enc(cfg):
            enc += 2 * fc * R + 2 * A * D * Hd
            enc += S0 * (2 * M * R * 4 * R + 2 * D * 4 * R + 2 * R * Hd
                         + 2 * A * Hd + 2 * A * D + 2 * R * C)
        enc += M * 2 * S0 * R * Hd
        enc += S * (2 * R * 4 * R + 2 * R * C
                    + M * (2 * R * Hd + 2 * S0 * Hd + 2 * S0 * R + 2 * R * 4 * R))
    else:
        (fc, A, D), = _enc(cfg)
        enc += 2 * fc * R + 2 * A * D * Hd
        enc += S * (2 * R * Hd + 2 * A * Hd + 2 * A * D + 2 * R * 4 * R + 2 * D * 4 * R
                    + 2 * R * C)
    enc += 2 * S * R * Hd  # the decoder's keys over the thoughts
    dec = (2 * E * 4 * R + 2 * R * 4 * R + 2 * R * 4 * R + 2 * R * Hd + 2 * S * Hd
           + 2 * S * R + 2 * R * V1)
    return float(enc) * enc_rows + float(dec) * dec_rows * dec_steps


def per_unit(cfg, traffic):
    """-> dict: the FLOPs of one step, iteration or batch of the traffic,
    and its attention reads' launches and bytes, forward and backward.

    xe      a training step over N = images x captions rows: forward
            (encoder over the N rows, decoder L + 1 steps) and backward;
    decode  a beam batch: the encoder over B images, the decoder L steps
            over B x beam lanes;
    scst    an iteration: the rollout (the encoder over N rows, the
            decoder L + 1 steps over 2N lanes) and a training step as XE's.
    """
    L, kind = cfg["seq_length"], traffic["kind"]
    e = DTYPE_BYTES[traffic["dtype"]]
    if kind == "decode":
        b = traffic["serve_batch"]
        fwd, bwd = attention_calls(cfg, b, b * traffic["beam_size"], L), []
        flops = forward_flops(cfg, b, b * traffic["beam_size"], L)
    elif kind in ("xe", "scst"):
        n = traffic["images_per_step"] * traffic["captions_per_image"]
        bwd = attention_calls(cfg, n, n, L + 1)
        fwd, flops = list(bwd), 3 * forward_flops(cfg, n, n, L + 1)
        if kind == "scst":
            fwd += attention_calls(cfg, n, 2 * n, L + 1)
            flops += forward_flops(cfg, n, 2 * n, L + 1)
    else:
        raise ValueError(f"no work model for traffic kind {kind!r}")
    return {
        "flops": flops,
        "fwd_launches": len(fwd),
        "fwd_bytes": sum(fwd_bytes(c, e) for c in fwd),
        "bwd_launches": len(bwd),
        "bwd_bytes": sum(bwd_bytes(c, e) for c in bwd),
    }
