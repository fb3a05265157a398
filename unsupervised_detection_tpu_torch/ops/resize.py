"""Image resizing with TF1 "legacy" sampling semantics, as matrix products.

Counterpart of unsupervised_detection_tpu/ops/resize.py. TF1's legacy
resize (align_corners=False, no half-pixel centres) samples output index
``i`` at ``src = i * in/out``, computed in float32. `F.interpolate` does not
match it, so each resize is two interpolation matrices, ``Y = Wh @ X @ Ww^T``
per channel, built on the host with numpy and applied with `torch.einsum`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _legacy_scale(in_size: int, out_size: int, align_corners: bool) -> np.float32:
    """TF1 CalculateResizeScale (evaluated in float32, as the TF kernel does)."""
    if align_corners and out_size > 1:
        return np.float32(in_size - 1) / np.float32(out_size - 1)
    return np.float32(in_size) / np.float32(out_size)


def _source_positions(in_size, out_size, align_corners, scale=None, offset=0.0):
    """Source sampling positions for each output index, `i * scale` in
    float32 (float64 positions shift the weights and break bit-parity)."""
    if scale is None:
        scale = _legacy_scale(in_size, out_size, align_corners)
    src = np.arange(out_size, dtype=np.float32) * np.float32(scale)
    return src.astype(np.float64) + offset


@functools.lru_cache(maxsize=None)
def bilinear_resize_weights_np(in_size: int, out_size: int, align_corners: bool = False,
                               scale: float | None = None, offset: float = 0.0,
                               clamp: tuple[float, float] | None = None) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, TF1 legacy
    semantics: the tent kernel at integer taps after clamping the source
    position into the valid window (`clamp` restricts it to a crop)."""
    lo, hi = clamp if clamp is not None else (0.0, in_size - 1)
    src = np.clip(_source_positions(in_size, out_size, align_corners, scale, offset), lo, hi)
    k = np.arange(in_size, dtype=np.float64)
    w = np.maximum(0.0, 1.0 - np.abs(src[:, None] - k[None, :]))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def nearest_resize_index_np(in_size: int, out_size: int, align_corners: bool = False,
                            scale: float | None = None, offset: float = 0.0,
                            clamp: tuple[float, float] | None = None) -> np.ndarray:
    """Source index per output index for TF1-legacy nearest-neighbor resize:
    floor(src) (round(src) with align_corners), clamped to the valid range."""
    lo, hi = clamp if clamp is not None else (0.0, in_size - 1)
    src = _source_positions(in_size, out_size, align_corners, scale, offset)
    idx = np.rint(src) if align_corners else np.floor(src)
    return np.clip(idx, lo, hi).astype(np.int64)


@functools.lru_cache(maxsize=None)
def nearest_resize_weights_np(in_size: int, out_size: int, align_corners: bool = False,
                              scale: float | None = None, offset: float = 0.0,
                              clamp: tuple[float, float] | None = None) -> np.ndarray:
    """(out_size, in_size) one-hot nearest-neighbor matrix."""
    idx = nearest_resize_index_np(in_size, out_size, align_corners, scale, offset, clamp)
    w = np.zeros((out_size, in_size), dtype=np.float32)
    w[np.arange(out_size), idx] = 1.0
    return w


def central_crop_fraction_box(in_size: int, fraction: float) -> tuple[int, int]:
    """(start, length) of TF1 tf.image.central_crop along one axis:
    `start = int((size - size * fraction) / 2)` in float64."""
    if fraction == 1.0:
        return 0, in_size
    d = float(in_size)
    start = int((d - d * fraction) / 2.0)
    return start, in_size - 2 * start


def _central_crop_weights_np(in_size: int, fraction: float, method: str) -> np.ndarray:
    """central_crop(fraction) followed by legacy resize back to `in_size`,
    as one matrix (reference data/davis2016_data_utils.py:129-133)."""
    start, length = central_crop_fraction_box(in_size, fraction)
    scale = np.float32(length) / np.float32(in_size)
    clamp = (float(start), float(start + length - 1))
    builder = bilinear_resize_weights_np if method == "bilinear" else nearest_resize_weights_np
    return builder(in_size, in_size, False, scale=scale, offset=float(start), clamp=clamp)


@functools.lru_cache(maxsize=None)
def _composed_bilinear_weights_np(in_size: int, mid_size: int, out_size: int) -> np.ndarray:
    """resize(in->mid) then resize(mid->out) composed into one (out, in)
    matrix (float64 product, rounded once to float32)."""
    w1 = bilinear_resize_weights_np(in_size, mid_size)
    w2 = bilinear_resize_weights_np(mid_size, out_size)
    return (w2.astype(np.float64) @ w1.astype(np.float64)).astype(np.float32)


def _matrix(builder, *args, like: torch.Tensor) -> torch.Tensor:
    """Interpolation matrix from a cached numpy builder, cached on the
    input's device in its compute dtype."""
    dtype = like.dtype if like.dtype in (torch.float32, torch.bfloat16) else torch.float32
    return _device_matrix(builder, args, like.device, dtype)


@functools.lru_cache(maxsize=64)
def _device_matrix(builder, args, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(builder(*args)).to(device=device, dtype=dtype)


def _apply_separable(x: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """Apply per-axis interpolation matrices to NHWC (or HWC) input."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    y = torch.einsum("oh,bhwc->bowc", wh, x)
    y = torch.einsum("pw,bowc->bopc", ww, y)
    return y[0] if squeeze else y


def _hw(x: torch.Tensor) -> tuple[int, int]:
    return (x.shape[1], x.shape[2]) if x.dim() == 4 else (x.shape[0], x.shape[1])


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """TF1-compatible bilinear resize of NHWC/HWC images to (height, width)."""
    (h, w), (in_h, in_w) = size, _hw(x)
    return _apply_separable(
        x, _matrix(bilinear_resize_weights_np, in_h, h, align_corners, like=x),
        _matrix(bilinear_resize_weights_np, in_w, w, align_corners, like=x))


def resize_nearest(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """TF1-compatible nearest-neighbor resize of NHWC/HWC images."""
    (h, w), (in_h, in_w) = size, _hw(x)
    return _apply_separable(
        x, _matrix(nearest_resize_weights_np, in_h, h, align_corners, like=x),
        _matrix(nearest_resize_weights_np, in_w, w, align_corners, like=x))


def central_crop_resize(x: torch.Tensor, fraction: float, method: str = "bilinear") -> torch.Tensor:
    """Central-crop by `fraction` and resize back to the original size, as
    one interpolation matrix per axis (the reference's test-time crop)."""
    if fraction == 1.0:
        return x
    in_h, in_w = _hw(x)
    return _apply_separable(
        x, _matrix(_central_crop_weights_np, in_h, fraction, method, like=x),
        _matrix(_central_crop_weights_np, in_w, fraction, method, like=x))


def resize_bilinear_composed(x: torch.Tensor, mid_hw, out_hw) -> torch.Tensor:
    """Resize to mid_hw then to out_hw in one matrix pair: fuses PWC's x4
    flow upsample with the working-resolution downsample
    (reference adversarial_learner.py:87-97)."""
    (mh, mw), (oh, ow), (in_h, in_w) = mid_hw, out_hw, _hw(x)
    return _apply_separable(
        x, _matrix(_composed_bilinear_weights_np, in_h, mh, oh, like=x),
        _matrix(_composed_bilinear_weights_np, in_w, mw, ow, like=x))
