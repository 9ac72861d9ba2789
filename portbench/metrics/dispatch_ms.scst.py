"""Host ms per iteration in queuing the RL step: the program's span
``rl.dispatch`` (``training/train_rl_loop.py::train_rl``), its records
in the traced window over the window's iterations
(``_program.per_unit``)."""

from portbench.metrics._program import per_unit


def read(ctx):
    return per_unit(ctx, "rl.dispatch", 1e3)
