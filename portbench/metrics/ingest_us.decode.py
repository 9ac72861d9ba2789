"""Host us per request in ``CaptionServer.submit`` up to its queue put
(the request's f32 read, cast and checks): the program's record
``serve.submit``, timed on the client's thread and recorded by the
server's worker as it takes the batch, its mean over the requests taken
in the traced window (``_program.window_mean``)."""

from portbench.metrics._program import window_mean


def read(ctx):
    return window_mean(ctx, "serve.submit", 1e6)
