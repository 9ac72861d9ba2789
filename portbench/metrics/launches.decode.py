"""Kernels launched per step or batch in the traced window (the
profiler's device events over the units of work done)."""

from portbench.metrics._common import launches_per_unit as read  # noqa: F401
