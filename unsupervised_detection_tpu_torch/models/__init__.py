"""The port's networks: PWCNet flow backbone and the mask generator."""

from .generator import GeneratorNet
from .pwcnet import PWCNet

__all__ = ["GeneratorNet", "PWCNet"]
