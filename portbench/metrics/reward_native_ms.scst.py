"""Host ms per iteration in the CIDEr-D scorer's C++ call: the program's
span ``reward.native`` (``rewards/cider_d.py::CiderD.score_arrays``), its
records in the traced window over the window's iterations
(``_program.per_unit``). None where the native engine is not built (the
numpy engine scores)."""

from portbench.metrics._program import per_unit


def read(ctx):
    return per_unit(ctx, "reward.native", 1e3)
