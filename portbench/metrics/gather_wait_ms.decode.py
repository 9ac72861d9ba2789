"""Host ms per batch the server's worker waits gathering its requests:
the program's span ``serve.gather`` (``decoding/serve.py::CaptionServer.
_run``, the calls that return a batch), its mean over the batches
gathered in the traced window (``_program.window_mean``)."""

from portbench.metrics._program import window_mean


def read(ctx):
    return window_mean(ctx, "serve.gather", 1e3)
