"""Segmentation metrics: IoU, MAE and foreground/background disambiguation.

Counterpart of unsupervised_detection_tpu/ops/metrics.py: the mask that
occupies less than 60% of the 2-pixel image border is the foreground
(reference general_utils.py:89-151, test_generator.py:19-40). Masks are
(B, H, W, 1); every function is batched.
"""

from __future__ import annotations

import torch

BORDER_THRESHOLD = 0.6
MASK_THRESHOLD = 0.1
GT_THRESHOLD = 0.01


def boundary_score(masks: torch.Tensor) -> torch.Tensor:
    """(B,) fraction of the 2-pixel border occupied by binary masks,
    normalized by 4H + 4W (corner pixels counted twice, as the reference)."""
    h, w = masks.shape[1], masks.shape[2]
    top = masks[:, 0:2].sum(dim=(1, 2, 3))
    bottom = masks[:, h - 2:h].sum(dim=(1, 2, 3))
    left = masks[:, :, 0:2].sum(dim=(1, 2, 3))
    right = masks[:, :, w - 2:w].sum(dim=(1, 2, 3))
    return (top + bottom + left + right) / (4.0 * w + 4.0 * h)


def disambiguate_forward_background(pred_masks: torch.Tensor,
                                    threshold: float = MASK_THRESHOLD) -> torch.Tensor:
    """Binary foreground masks: the thresholded mask or its complement,
    whichever occupies less of the border."""
    binary = (pred_masks > threshold).float()
    keep = (boundary_score(binary) < BORDER_THRESHOLD).float()[:, None, None, None]
    return keep * binary + (1.0 - keep) * (1.0 - binary)


def iou(gt_masks: torch.Tensor, pred_masks: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """(B,) intersection over union (+epsilon in the denominator) of
    boolean or {0,1} masks (reference tf_iou_computation)."""
    gt = gt_masks.bool()
    pred = pred_masks.bool()
    union = (gt | pred).float().sum(dim=(1, 2, 3)) + epsilon
    inter = (gt & pred).float().sum(dim=(1, 2, 3))
    return inter / union


def compute_all_iou(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                    threshold: float = MASK_THRESHOLD) -> torch.Tensor:
    """Validation IoU: disambiguate fg/bg, then IoU against GT > 0.01."""
    return iou(gt_masks=gt_masks > GT_THRESHOLD,
               pred_masks=disambiguate_forward_background(pred_masks, threshold))


def mae(gt_mask: torch.Tensor, pred_mask: torch.Tensor) -> torch.Tensor:
    """Mean absolute error between masks (test_generator.py:38-40)."""
    return (gt_mask - pred_mask).abs().mean()


def eval_iou_mae(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                 threshold: float = MASK_THRESHOLD):
    """Per-sample IoU and MAE with the reference's eval semantics
    (test_generator.py:19-40): binarize at `threshold`, flip to the
    complement when the mask holds >= 60% of the border, GT truthiness is
    any nonzero pixel, IoU = 1 when both masks are empty, MAE between the
    soft GT and the binary annotation. Returns two (B,) float32 tensors."""
    ann = disambiguate_forward_background(pred_masks, threshold)
    ann_b = ann > 0.5
    gt_b = gt_masks.bool()
    inter = (ann_b & gt_b).float().sum(dim=(1, 2, 3))
    union = (ann_b | gt_b).float().sum(dim=(1, 2, 3))
    iou_b = torch.where(union == 0, torch.ones_like(union), inter / union.clamp(min=1.0))
    mae_b = (gt_masks.float() - ann).abs().mean(dim=(1, 2, 3))
    return iou_b, mae_b
