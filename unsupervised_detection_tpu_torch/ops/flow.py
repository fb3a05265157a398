"""Flow preprocessing: counterpart of unsupervised_detection_tpu/ops/flow.py
(`standardize_flow` only; the Middlebury colorization waits for the
visualization slice)."""

from __future__ import annotations

import torch


def standardize_flow(flow: torch.Tensor, epsilon: float = 0.0) -> torch.Tensor:
    """Per-image, per-channel zero-mean unit-variance flow over the spatial
    axes of (B, H, W, 2) (tf.nn.moments over axes [1, 2]; population
    variance)."""
    mean = flow.mean(dim=(1, 2), keepdim=True)
    var = ((flow - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    return (flow - mean) / torch.sqrt(var + epsilon)
