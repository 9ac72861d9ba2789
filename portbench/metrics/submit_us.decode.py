"""Host us per ``CaptionServer.submit`` call (the benchmark's span around
each submit of its clients)."""


def read(ctx):
    m = ctx.spans.mean("submit")
    return None if m is None else 1e6 * m
