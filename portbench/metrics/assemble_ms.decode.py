"""Host ms per batch in its assembly: stacking the requests, pinning and
queuing the H2D copy, the device pad (the program's span
``serve.assemble``, ``decoding/serve.py::CaptionServer._dispatch``), its
mean over the batches assembled in the traced window
(``_program.window_mean``)."""

from portbench.metrics._program import window_mean


def read(ctx):
    return window_mean(ctx, "serve.assemble", 1e3)
