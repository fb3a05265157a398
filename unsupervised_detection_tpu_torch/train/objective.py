"""The inference half of the contextual-information-separation objective,
counterpart of unsupervised_detection_tpu/train/objective.py:48-133:

  flow = PWC(I1, I2) at reader resolution, resized to the working
         resolution with the vectors NOT rescaled (reference
         adversarial_learner.py:87-97) and divided by flow_normalizer;
  M    = G(I1, standardize(flow)).

The recover net and the losses come with the training slice.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..device import compute_dtype, resolve_device
from ..models import GeneratorNet, PWCNet
from ..ops.flow import standardize_flow
from ..ops.resize import resize_bilinear, resize_bilinear_composed


class AdversarialObjective:
    """Holds the generator and the frozen PWC net for one config on one
    device. Weights come from `load_state_dicts` (see convert.py)."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.dtype = compute_dtype(config.compute_dtype)
        self.generator = GeneratorNet(dtype=self.dtype).to(self.device).eval()
        self.pwc = PWCNet(
            pyr_lvls=config.pwc_pyr_lvls,
            flow_pred_lvl=config.pwc_flow_pred_lvl,
            search_range=config.pwc_search_range,
            dtype=self.dtype,
        ).to(self.device).eval()

    def load_state_dicts(self, gen_state: dict, pwc_state: dict) -> None:
        self.generator.load_state_dict(gen_state)
        self.pwc.load_state_dict(pwc_state)

    @property
    def fuse_flow_resize(self) -> bool:
        return self.dtype == torch.bfloat16

    def compute_flow(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """Frozen PWC flow. In the fused-resize (bfloat16) mode it stays at
        quarter resolution for `resize_to_working`. With
        flow_resolution_divisor > 1 the flow net runs on downscaled frames."""
        d = self.config.flow_resolution_divisor
        if d > 1:
            size = (self.config.reader_height // d, self.config.reader_width // d)
            mult = 2**self.pwc.pyr_lvls
            if size[0] % mult or size[1] % mult:
                raise ValueError(f"flow resolution {size} not divisible by {mult}")
            img1 = resize_bilinear(img1, size)
            img2 = resize_bilinear(img2, size)
        with torch.no_grad():
            return self.pwc(img1, img2, upsample_output=not self.fuse_flow_resize)

    def resize_to_working(self, img1: torch.Tensor, flow: torch.Tensor):
        """Image and flow at the working resolution; flow vectors keep
        reader-resolution pixel units and are divided by flow_normalizer."""
        cfg = self.config
        d = cfg.flow_resolution_divisor
        size = (cfg.img_height, cfg.img_width)
        image = resize_bilinear(img1, size)
        if self.fuse_flow_resize:
            # quarter-res flow -> working res in one composed resize; the x4
            # magnitude scale and the divisor commute with the resize
            mid = (cfg.reader_height // d, cfg.reader_width // d)
            scale = 2**self.pwc.flow_pred_lvl * d
            flow = resize_bilinear_composed(flow, mid, size) * (scale / cfg.flow_normalizer)
        else:
            if d > 1:
                flow = flow * d
            flow = resize_bilinear(flow, size) / cfg.flow_normalizer
        return image, flow

    def generate_mask(self, image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        return self.generator(image, standardize_flow(flow))
