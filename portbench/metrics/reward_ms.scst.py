"""Host ms per iteration in the CIDEr-D scorer handed to ``train_rl`` (the
benchmark's span around its ``score_arrays``)."""


def read(ctx):
    m = ctx.spans.mean("reward")
    return None if m is None else 1e3 * m
