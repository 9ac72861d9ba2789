"""Shared arithmetic of the per-layer metric readers. Each reader file is
named after its metric and defines ``read(ctx) -> float | None``; ``ctx``
(``harness/readers.py::Context``) holds the traced window's summary, the
benchmark's host spans, the counts of work done in the window, the
configuration and the traffic. A reader that finds nothing to read returns
None, and the metric is left out of the line."""

from __future__ import annotations

from portbench.harness.model_math import PEAKS, per_unit

FWD, BWD = "additive_attention_fwd", "additive_attention_bwd_rows"


def launches_per_unit(ctx):
    units = ctx.counts.get("units")
    if not units or not ctx.summary["kernels"]:
        return None
    return len(ctx.summary["kernels"]) / units


def attn_roofline(ctx):
    """The attention kernels' share of their bound: the bytes of the reads
    they ran in the window / 3.35 TB/s over their device time. The kernels
    are counted from the trace (forward: one kernel a read; backward: the
    rows kernel, its reduction beside it), and the bytes per read are the
    traffic's average; None where the program's own launch counters do not
    match the configuration's reads (the path changed)."""
    units = ctx.counts.get("units")
    unit = per_unit(ctx.config, ctx.traffic)
    if not units or ctx.counts.get("attn_fwd") != unit["fwd_launches"] * units \
            or ctx.counts.get("attn_bwd") != unit["bwd_launches"] * units:
        return None
    ks = [k for k in ctx.summary["kernels"] if "additive_attention" in k[0]]
    n_fwd = sum(1 for k in ks if FWD in k[0])
    n_bwd = sum(1 for k in ks if BWD in k[0])
    secs = sum(k[2] for k in ks) / 1e6
    if not secs or not n_fwd:
        return None
    nbytes = n_fwd * unit["fwd_bytes"] / unit["fwd_launches"]
    if unit["bwd_launches"]:
        nbytes += n_bwd * unit["bwd_bytes"] / unit["bwd_launches"]
    return 100.0 * nbytes / PEAKS["hbm_bytes_per_s"] / secs


def mfu(ctx):
    """The model's FLOPs for the steps or batches done in the window over
    the window's length and the chip's peak in the traffic's dtype."""
    units = ctx.counts.get("units")
    if not units or not ctx.summary["window_s"]:
        return None
    flops = per_unit(ctx.config, ctx.traffic)["flops"] * units
    return 100.0 * flops / ctx.summary["window_s"] / PEAKS[ctx.traffic["dtype"]]


def device_idle(ctx):
    s = ctx.summary
    if not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
