"""The port's networks: PWCNet flow backbone, the mask generator and the
recover (flow-inpainting) net."""

from .generator import GeneratorNet
from .pwcnet import PWCNet
from .recover import RecoverNet

__all__ = ["GeneratorNet", "PWCNet", "RecoverNet"]
