"""Host ms per iteration in the CIDEr-D scorer's Python before its C++
call (token checks, grouping, flattening): the program's span
``reward.prep`` (``rewards/cider_d.py::CiderD.score_arrays``), its
records in the traced window over the window's iterations
(``_program.per_unit``)."""

from portbench.metrics._program import per_unit


def read(ctx):
    return per_unit(ctx, "reward.prep", 1e3)
