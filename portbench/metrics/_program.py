"""Shared rules of the readers of the program's own spans and counters
(``recurrent_fusion_network_torch/utils/profiling.py``: ``span``,
``count``, ``aggregate``). A program without them (an older checkout)
gives None, and the metric is left out of the line.

Every reader takes the records made while a profiler ran in the process,
on any thread (``Aggregate.traced_total`` / ``traced_count``): in a
``--trace 1`` run that is the harness's profiler, started and stopped
around the traced window, so the records are the window's, whichever
thread made them. Training cells: their sum over the units of work done
in the window. Serving cell: their mean, per batch or per request."""

from __future__ import annotations


def _aggregate(name):
    """The program's aggregates of ``name``, or None where the program
    keeps no such tracer or recorded no ``name``."""
    try:
        from recurrent_fusion_network_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "aggregate", None)
    agg = read(name) if read else None
    return agg if agg is not None and hasattr(agg, "traced_total") else None


def per_unit(ctx, name, scale, *, none_is_zero=False):
    """``scale`` x the sum of ``name``'s records in the window / the
    window's units. ``none_is_zero``: a span recorded by the program but
    not in the window (a collection that did not happen) reads 0."""
    units, agg = ctx.counts.get("units"), _aggregate(name)
    if not units or agg is None:
        return None
    if not agg.traced_count:
        return 0.0 if none_is_zero else None
    return scale * agg.traced_total / units


def window_mean(ctx, name, scale):
    """``scale`` x the mean of ``name``'s records in the window."""
    agg = _aggregate(name)
    if agg is None or not agg.traced_count:
        return None
    return scale * agg.traced_total / agg.traced_count
