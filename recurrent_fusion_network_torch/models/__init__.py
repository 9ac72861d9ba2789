"""Caption models of the port (this slice: RecurrentFusionModel)."""

from .base import setup
from .recurrent_fusion import RecurrentFusionModel

__all__ = ["RecurrentFusionModel", "setup"]
