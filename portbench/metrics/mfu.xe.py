"""The whole step's or batch's share of the chip's peak FLOP/s."""

from portbench.metrics._common import mfu as read  # noqa: F401
