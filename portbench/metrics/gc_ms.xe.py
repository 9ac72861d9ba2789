"""Host ms per step in interpreter collections, on any thread (a
collection on the prefetch or a fill thread holds the interpreter as long
as one on the loop's): the program's span ``gc`` (``utils/profiling.py``,
a ``gc.callbacks`` hook), its records in the traced window over the
window's steps (``_program.per_unit``); 0 when no collection ran in the
window."""

from portbench.metrics._program import per_unit


def read(ctx):
    return per_unit(ctx, "gc", 1e3, none_is_zero=True)
