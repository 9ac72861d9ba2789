"""Caption models of the port: ShowTell, ReviewNet and RecurrentFusionModel."""

from .base import setup
from .recurrent_fusion import RecurrentFusionModel
from .review_net import ReviewNetModel
from .show_tell import ShowTellModel

__all__ = ["RecurrentFusionModel", "ReviewNetModel", "ShowTellModel", "setup"]
