"""The additive-attention kernels' share of their memory bound."""

from portbench.metrics._common import attn_roofline as read  # noqa: F401
