"""Host ms per step blocked in the loader's prefetch queue: the program's
span ``loader.wait`` (``data/loader.py::DataLoader._get_prefetched``),
its records in the traced window over the window's steps
(``_program.per_unit``)."""

from portbench.metrics._program import per_unit


def read(ctx):
    return per_unit(ctx, "loader.wait", 1e3)
