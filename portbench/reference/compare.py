"""The numbers that decide ``correct``, each a worst case over what a run
compares. All are gaps between the program's reading and the reference's,
so a sound run reads near 0 and each has an upper limit.

Training (three XE steps from the seed's weights on the loader's first
three batches):
  loss_gap     max over the steps of |loss - ref| / |ref|;
  grad_gap     the first step's gradient as the optimizer took it (clamped,
               decayed): max over leaves of | |g| - |g_ref| | / max(|g_ref|,
               the median leaf's |g_ref|);
  change_gap   the parameters' change after the three steps, the same way,
               over the leaves whose reference gradient is at least a
               thousandth of the median leaf's (the others move by
               round-off under Adam);
  label_rows   rows of the loader's batches whose captions, masks or top
               words differ from the corpus's for the image it names.
Serving (a sample of the requests finished in the window):
  lp_gap       max over served tokens, through EOS, of |the served
               log-prob - the reference's for the same token and prefix|;
  beam_gap     the search: per request, the reference's summed log-prob of
               its own beam-search best on the same features minus that of
               the served caption; the median over the requests. The
               served beams part from the reference's at bf16 near-ties on
               some requests, either way, so only a search that does worse
               on most requests (greedy, a narrower beam) moves the median.
"""

from __future__ import annotations

import statistics

MOVED = 1e-3  # a leaf moves when its reference gradient is this share of the median's


def _norm_gap(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def xe_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [...], "grads": {leaf: norm}, "changes": {leaf: norm}}."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap = _norm_gap(prog["grads"], ref["grads"], ref["grads"])
    med = statistics.median(ref["grads"].values())
    moved = [k for k, g in ref["grads"].items() if g >= MOVED * med]
    change_gap = _norm_gap(prog["changes"], ref["changes"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "excluded_leaves": len(ref["grads"]) - len(moved)}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves that set ``grad_gap`` and ``change_gap``: [name,
    gap, program's norm, reference's norm, reference's gradient norm]
    (calibration)."""
    med_g = statistics.median(ref["grads"].values())
    moved = [k for k, g in ref["grads"].items() if g >= MOVED * med_g]
    out = {}
    for key, keys in (("grads", list(ref["grads"])), ("changes", moved)):
        med = statistics.median(ref[key][k] for k in keys)
        rows = [[k, abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med), prog[key][k],
                 ref[key][k], ref["grads"][k]] for k in keys]
        out[key] = sorted(rows, key=lambda r: -r[1])[:n] + [["median", med]]
    return out


def decode_numbers(served_lps, ref_lps, lengths) -> dict:
    """served_lps / ref_lps: (n, L) per-token log-probs; lengths: tokens
    compared per request (through EOS)."""
    gap = 0.0
    for s, r, n in zip(served_lps, ref_lps, lengths):
        if n:
            gap = max(gap, float((s[:n] - r[:n]).abs().max()))
    return {"lp_gap": gap}


def beam_numbers(served_sums, best_sums) -> dict:
    """served_sums: the reference's summed log-prob of each served caption
    (through EOS); best_sums: that of the reference's own beam-search best
    on the same features. Per request, gap = best - served: positive where
    the served caption scores below the reference's best."""
    gaps = [b - s for s, b in zip(served_sums, best_sums)]
    if not gaps:
        return {"beam_gap": float("inf"), "beam_gaps": []}
    return {"beam_gap": statistics.median(gaps),
            "beam_gaps": [round(g, 5) for g in gaps]}
