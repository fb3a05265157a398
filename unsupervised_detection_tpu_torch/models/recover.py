"""Flow-inpainting recover network, counterpart of
unsupervised_detection_tpu/models/recover.py (reference nets.py:45-110).

Two siamese 9-conv strided encoders -- the image stream `aconv*` and the
flow stream `bconv*`, whose input is concat(masked flow[2], ones[1],
1 - mask[1]) -- and a decoder with a flow head per scale (`flow5..flow1`,
`flow1` k=5), resize-conv upsampling to each skip's size (`deconv*`,
`upflow*`, k=4) and a final float32 bilinear resize to the input size.
Channel multiplier f=0.25.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from ..utils.profiling import span
from .layers import BiasedConv, ResizeConv

# (name, out channels at f=1, kernel, stride) of each encoder stream
ENCODER = (("conv1", 64, 7, 2), ("conv2", 128, 5, 2), ("conv3", 256, 5, 2),
           ("conv31", 256, 3, 1), ("conv4", 512, 3, 2), ("conv41", 512, 3, 1),
           ("conv5", 512, 3, 2), ("conv51", 512, 3, 1), ("conv6", 512, 3, 2))
# decoder level -> (deconv out channels at f=1, encoder skip it resizes to)
DECODER = ((5, 512, "conv51"), (4, 512, "conv41"), (3, 256, "conv31"),
           (2, 128, "conv2"), (1, 64, "conv1"))


class RecoverNet(nn.Module):
    """Flow inpainter: NHWC image (B, H, W, 3), masked flow (B, H, W, C) and
    mask (B, H, W, 1) in, (B, H, W, C) float32 recovered flow out. Computes
    in `dtype`; parameters stay float32."""

    def __init__(self, f: float = 0.25, flow_channels: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        ch = {name: int(n * f) for name, n, _, _ in ENCODER}
        for stream, in_ch in (("a", 3), ("b", flow_channels + 2)):
            for name, _, k, s in ENCODER:
                self.add_module(stream + name, BiasedConv(in_ch, ch[name], k, s))
                in_ch = ch[name]
        concat = 2 * ch["conv6"]
        for lvl, n, skip in DECODER:
            out = int(n * f)
            self.add_module(f"deconv{lvl}", ResizeConv(concat, out))
            if lvl != 5:
                self.add_module(f"upflow{lvl}", ResizeConv(flow_channels, flow_channels,
                                                           activation=False))
            # deconv, both streams' skips and, below level 5, the upflow
            concat_next = out + 2 * ch[skip] + (flow_channels if lvl != 5 else 0)
            self.add_module(f"flow{lvl}", BiasedConv(concat_next, flow_channels,
                                                     5 if lvl == 1 else 3, activation=False))
            concat = concat_next

    def forward(self, img1: torch.Tensor, flow_masked: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        with span("ud.model.recover"):
            orig_hw = (img1.shape[1], img1.shape[2])
            ones = torch.ones_like(flow_masked[..., 0:1])
            flow_in = torch.cat([flow_masked, ones, 1.0 - mask], dim=3)
            skips = {}
            for stream, x in (("a", img1), ("b", flow_in)):
                x = x.to(self.dtype).permute(0, 3, 1, 2)
                for name, _, _, _ in ENCODER:
                    x = getattr(self, stream + name)(x)
                    skips[stream + name] = x

            x = torch.cat([skips["aconv6"], skips["bconv6"]], dim=1)
            flow = None
            for lvl, _, skip in DECODER:
                size = tuple(skips["b" + skip].shape[2:])
                parts = [getattr(self, f"deconv{lvl}")(x, size), skips["b" + skip],
                         skips["a" + skip]]
                if flow is not None:
                    parts.append(getattr(self, f"upflow{lvl}")(flow, size))
                x = torch.cat(parts, dim=1)
                flow = getattr(self, f"flow{lvl}")(x)
            return resize_bilinear(flow.float().permute(0, 2, 3, 1), orig_hw)
