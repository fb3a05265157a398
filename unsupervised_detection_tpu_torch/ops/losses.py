"""Loss primitive of the contextual-information-separation objective,
counterpart of unsupervised_detection_tpu/ops/losses.py: the masked
Charbonnier penalty of the reference (models/utils/loss_utils.py:34-51)."""

from __future__ import annotations

import torch

CHARBONNIER_EPSILON = 1e-3


def charbonnier_loss(gt_flows: torch.Tensor, pred_flows: torch.Tensor,
                     masks: torch.Tensor, cbn: float = 0.5) -> torch.Tensor:
    """(B,) sum over pixels and channels of ((gt - pred)^2 + eps^2)^cbn x
    mask; `masks` broadcasts to (B, H, W, C)."""
    diff = gt_flows - pred_flows
    penalty = torch.pow(diff * diff + CHARBONNIER_EPSILON**2, cbn) * masks
    return penalty.sum(dim=(1, 2, 3))
