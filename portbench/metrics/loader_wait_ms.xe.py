"""Host ms per step in the loader's ``get_batch`` (the benchmark's span
around the loader it hands to ``train``)."""


def read(ctx):
    m = ctx.spans.mean("loader")
    return None if m is None else 1e3 * m
