"""PWCNet optical-flow backbone, counterpart of
unsupervised_detection_tpu/models/pwcnet.py.

6-level siamese feature pyramid (16..196 channels) run as one 2B batch,
coarse-to-fine estimation from level 6 to level 2 with a backward warp and
a cost volume per level, DenseNet-connected flow estimators, dilated
context refinement, transposed-conv upsampling between levels and a final
x4 bilinear upsample with a x4 magnitude scale (reference
model_pwcnet.py:8-19, 581-649).

Per forward the cost volume runs once per level (5 launches, L6..L2) and
the warp once per level below the top (4 launches, L5..L2); both go
through the CUDA kernels on a CUDA device, and a backward pass through PWC
(pretraining) launches their backward kernels as often. Images and flows are NHWC at
the interface; inside, activations are NCHW views of channels-last memory,
so `permute(0, 2, 3, 1)` hands the kernels NHWC-contiguous tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.cost_volume import cost_volume
from ..ops.resize import resize_bilinear
from ..ops.warp import dense_image_warp
from .layers import ConvTranspose2D, PWCConv

PYRAMID_CHANNELS = (None, 16, 32, 64, 96, 128, 196)
ESTIMATOR_CHANNELS = (128, 128, 96, 64, 32)
CONTEXT_LAYERS = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class FeaturePyramid(nn.Module):
    """Siamese 6-level feature extractor (model_pwcnet.py:81-168)."""

    def __init__(self, pyr_lvls: int = 6):
        super().__init__()
        in_ch = 3
        for lvl in range(1, pyr_lvls + 1):
            f = PYRAMID_CHANNELS[lvl]
            self.add_module(f"conv{lvl}a", PWCConv(in_ch, f, 3, 2))
            self.add_module(f"conv{lvl}aa", PWCConv(f, f, 3, 1))
            self.add_module(f"conv{lvl}b", PWCConv(f, f, 3, 1))
            in_ch = f
        self.pyr_lvls = pyr_lvls

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for lvl in range(1, self.pyr_lvls + 1):
            for suffix in ("a", "aa", "b"):
                x = getattr(self, f"conv{lvl}{suffix}")(x)
            feats.append(x)
        return feats  # feats[i] is pyramid level i+1


class FlowEstimator(nn.Module):
    """Dense-connected flow estimator of one level (model_pwcnet.py:345-506):
    each conv's input is the concat of all earlier activations, newest
    first. Returns (dense features, flow)."""

    def __init__(self, lvl: int, in_ch: int):
        super().__init__()
        self.lvl = lvl
        for i, f in enumerate(ESTIMATOR_CHANNELS):
            self.add_module(f"conv{lvl}_{i}", PWCConv(in_ch, f))
            in_ch += f
        self.add_module(f"flow{lvl}", PWCConv(in_ch, 2, activation=False))
        self.out_ch = in_ch

    def forward(self, x: torch.Tensor):
        for i in range(len(ESTIMATOR_CHANNELS)):
            x = torch.cat([getattr(self, f"conv{self.lvl}_{i}")(x), x], dim=1)
        return x, getattr(self, f"flow{self.lvl}")(x)


class ContextNet(nn.Module):
    """Dilated context refinement (model_pwcnet.py:511-576): flow + residual."""

    def __init__(self, lvl: int, in_ch: int):
        super().__init__()
        self.lvl = lvl
        for i, (f, rate) in enumerate(CONTEXT_LAYERS, start=1):
            self.add_module(f"dc_conv{lvl}{i}", PWCConv(in_ch, f, rate=rate))
            in_ch = f
        self.add_module(f"dc_conv{lvl}7", PWCConv(in_ch, 2, activation=False))

    def forward(self, feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        x = feat
        for i in range(1, len(CONTEXT_LAYERS) + 2):
            x = getattr(self, f"dc_conv{self.lvl}{i}")(x)
        return flow + x


class PWCNet(nn.Module):
    """Coarse-to-fine flow network. Inputs are NHWC float32 images in
    [-0.5, 0.5] (shifted to [0, 1] inside, adapt_x); H and W divisible by
    2**pyr_lvls. Computes in `dtype`; returns float32 NHWC flow, channel 0
    is y."""

    def __init__(self, pyr_lvls: int = 6, flow_pred_lvl: int = 2,
                 search_range: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pyr_lvls, self.flow_pred_lvl = pyr_lvls, flow_pred_lvl
        self.search_range, self.dtype = search_range, dtype
        self.featpyr = FeaturePyramid(pyr_lvls)
        n_off = (2 * search_range + 1) ** 2
        for lvl in range(pyr_lvls, flow_pred_lvl - 1, -1):
            in_ch = n_off if lvl == pyr_lvls else n_off + PYRAMID_CHANNELS[lvl] + 4
            est = FlowEstimator(lvl, in_ch)
            self.add_module(f"estimator{lvl}", est)
            self.add_module(f"ctxt{lvl}", ContextNet(lvl, est.out_ch))
            if lvl != flow_pred_lvl:
                self.add_module(f"up_flow{lvl}", ConvTranspose2D(2, 2, 4, 2))
                self.add_module(f"up_feat{lvl}", ConvTranspose2D(est.out_ch, 2, 4, 2))

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                upsample_output: bool = True, return_pyramid: bool = False):
        """Flow of the pair, float32 NHWC. With `return_pyramid`, also the
        per-level flows, coarse to fine (L6..L2), NHWC in the compute dtype,
        as `(flow, flow_pyr)`: what pretraining's multiscale EPE reads."""
        b = img1.shape[0]
        both = torch.cat([img1 + 0.5, img2 + 0.5], dim=0).to(self.dtype)
        feats = self.featpyr(_nchw(both))
        c1 = [None] + [f[:b] for f in feats]
        c2 = [None] + [f[b:] for f in feats]

        up_flow = up_feat = None
        flow_pyr = []
        for lvl in range(self.pyr_lvls, self.flow_pred_lvl - 1, -1):
            if lvl == self.pyr_lvls:
                x = _nchw(cost_volume(_nhwc(c1[lvl]), _nhwc(c2[lvl]), self.search_range))
            else:
                # upsampled flow in this level's pixel units (model_pwcnet.py:616)
                warped = dense_image_warp(_nhwc(c2[lvl]), _nhwc(up_flow * (20.0 / 2**lvl)))
                corr = _nchw(cost_volume(_nhwc(c1[lvl]), warped, self.search_range))
                x = torch.cat([corr, c1[lvl], up_flow, up_feat], dim=1)
            feat, flow = getattr(self, f"estimator{lvl}")(x)
            flow = getattr(self, f"ctxt{lvl}")(feat, flow)
            flow_pyr.append(flow)
            if lvl != self.flow_pred_lvl:
                up_flow = getattr(self, f"up_flow{lvl}")(flow)
                up_feat = getattr(self, f"up_feat{lvl}")(feat)

        flow = _nhwc(flow.float())
        if upsample_output:
            scaler = 2**self.flow_pred_lvl
            size = (flow.shape[1] * scaler, flow.shape[2] * scaler)
            flow = resize_bilinear(flow, size) * scaler
        # else quarter resolution: the caller fuses the x4 upsample into its
        # own resize and applies the x4 magnitude scale
        if return_pyramid:
            return flow, [_nhwc(f) for f in flow_pyr]
        return flow
