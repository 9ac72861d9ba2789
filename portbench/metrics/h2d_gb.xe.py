"""GB copied host to device per step: the program's counter ``h2d_bytes``
(``data/pinned.py::SideStreamCopier.copy``: features, labels, masks and
top words), its increments in the traced window over the window's steps
(``_program.per_unit``). None on the CPU, where nothing is copied."""

from portbench.metrics._program import per_unit


def read(ctx):
    return per_unit(ctx, "h2d_bytes", 1e-9)
