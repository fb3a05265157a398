"""Flow preprocessing and the Middlebury flow colorization, on the flow's
device: counterpart of unsupervised_detection_tpu/ops/flow.py (reference
models/utils/flow_utils.py:5-109)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def standardize_flow(flow: torch.Tensor, epsilon: float = 0.0) -> torch.Tensor:
    """Per-image, per-channel zero-mean unit-variance flow over the spatial
    axes of (B, H, W, 2) (tf.nn.moments over axes [1, 2]; population
    variance)."""
    mean = flow.mean(dim=(1, 2), keepdim=True)
    var = ((flow - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    return (flow - mean) / torch.sqrt(var + epsilon)


@functools.lru_cache(maxsize=1)
def _color_wheel_np() -> np.ndarray:
    """The 55x3 Middlebury color wheel (flow_utils.py:14-42)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel.astype(np.float32)


def flow_to_image(flow: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) Middlebury colors in [0, 255] (whole levels) of a
    (B, H, W, 2) flow, as the reference's numpy pipeline: components above
    1e7 count as unknown (zero), the radius is normalized by its maximum over
    the whole batch (plus float64's eps), colors are interpolated on the
    wheel (index k1 wraps at ncols + 1 to 1) and saturated radii are dimmed
    by 0.75."""
    wheel = torch.from_numpy(_color_wheel_np()).to(flow.device)
    ncols = wheel.shape[0]
    u, v = flow[..., 0], flow[..., 1]
    known = (u.abs() <= 1e7) & (v.abs() <= 1e7)
    u = torch.where(known, u, torch.zeros_like(u))
    v = torch.where(known, v, torch.zeros_like(v))

    norm = torch.sqrt(u * u + v * v).max() + np.finfo(np.float64).eps
    u, v = u / norm, v / norm
    rad = torch.sqrt(u * u + v * v)
    angle = torch.atan2(-v, -u) / math.pi
    fk = (angle + 1.0) / 2.0 * (ncols - 1) + 1.0
    k0 = torch.floor(fk).to(torch.int64)
    k1 = torch.where(k0 + 1 == ncols + 1, torch.ones_like(k0), k0 + 1)
    f = (fk - k0)[..., None]

    col0 = wheel[k0 - 1] / 255.0
    col1 = wheel[k1 - 1] / 255.0
    col = (1.0 - f) * col0 + f * col1
    col = torch.where((rad <= 1.0)[..., None], 1.0 - rad[..., None] * (1.0 - col), col * 0.75)
    return torch.floor(255.0 * col)


def flow_to_image_summary(flow: torch.Tensor) -> torch.Tensor:
    """The colorized flow rescaled to [-0.5, 0.5] for image summaries
    (flow_utils.py:102-109)."""
    return flow_to_image(flow) / 255.0 - 0.5
