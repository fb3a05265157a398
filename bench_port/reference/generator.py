"""Mask generator of the plain reference, frozen from the port's
models/generator.py, float32 (the reference's nets.py:4-42): an
encoder/decoder over concat(image[3], standardized flow[2]) with two
stride-2 downsamples, four dilated convs (rates 2/4/8/16), additive skips at
three scales, and a temperature-10 two-way softmax whose channel 0 is the
mask probability."""

from __future__ import annotations

import torch
from torch import nn

from .layers import GenConv, GenDeconv


class GeneratorNet(nn.Module):
    """Mask net: NHWC float32 images in [-0.5, 0.5] and standardized flows
    in, (B, H, W, 1) float32 mask in [0, 1] out."""

    def __init__(self, cnum: int = 32):
        super().__init__()
        c = cnum
        self.conv1 = GenConv(5, c, 5)
        self.conv2_downsample = GenConv(c, 2 * c, 3, 2)
        self.conv3 = GenConv(2 * c, 2 * c, 3)
        self.conv4_downsample = GenConv(2 * c, 4 * c, 3, 2)
        self.conv5 = GenConv(4 * c, 4 * c, 3)
        self.conv6 = GenConv(4 * c, 4 * c, 3)
        self.conv7_atrous = GenConv(4 * c, 4 * c, 3, rate=2)
        self.conv8_atrous = GenConv(4 * c, 4 * c, 3, rate=4)
        self.conv9_atrous = GenConv(4 * c, 4 * c, 3, rate=8)
        self.conv10_atrous = GenConv(4 * c, 4 * c, 3, rate=16)
        self.conv11 = GenConv(4 * c, 4 * c, 3)
        self.conv12 = GenConv(4 * c, 4 * c, 3)
        self.conv13_upsample = GenDeconv(4 * c, 2 * c)
        self.conv14 = GenConv(2 * c, 2 * c, 3)
        self.conv15_upsample = GenDeconv(2 * c, c)
        self.conv16 = GenConv(c, c // 2, 3)
        self.conv17 = GenConv(c // 2, 2, 3, activation=False)

    def forward(self, images: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
        x = torch.cat([images, flows], dim=3).float().permute(0, 3, 1, 2)
        x0 = self.conv1(x)
        x1 = self.conv3(self.conv2_downsample(x0))
        x2 = self.conv6(self.conv5(self.conv4_downsample(x1)))
        x = self.conv10_atrous(self.conv9_atrous(self.conv8_atrous(self.conv7_atrous(x2))))
        x = self.conv11(x) + x2
        x = self.conv13_upsample(self.conv12(x))
        x = self.conv14(x) + x1
        x = self.conv15_upsample(x) + x0
        x = self.conv17(self.conv16(x))
        # temperature 10 (nets.py:37-41); softmax over {mask, not-mask}
        mask = torch.softmax(x / 10.0, dim=1)[:, 0:1]
        return mask.permute(0, 2, 3, 1)
