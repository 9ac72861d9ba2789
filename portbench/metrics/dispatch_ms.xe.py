"""Host ms per step in queuing the XE step (forward, backward, clip and
Adam): the program's span ``train.dispatch``
(``training/train_loop.py::train``), its records in the traced window
over the window's steps (``_program.per_unit``)."""

from portbench.metrics._program import per_unit


def read(ctx):
    return per_unit(ctx, "train.dispatch", 1e3)
