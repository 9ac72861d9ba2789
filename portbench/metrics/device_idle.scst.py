"""1 - the union of kernel and copy intervals over the traced window, %."""

from portbench.metrics._common import device_idle as read  # noqa: F401
