"""Backward bilinear warp: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of unsupervised_detection_tpu/ops/warp.py (`_warp_quad` and the
Pallas-backed `_warp_window`): output(b, y, x) = image(b, y - flow_y,
x - flow_x), bilinear, with floors clamped to [0, H-2] x [0, W-2], weights
clamped to [0, 1] and the lerp in TF order, x first then y (reference
core_warp.py:94-150). Flow channel 0 is y.
"""

from __future__ import annotations

import torch

from ._build import DTYPE_CODES, library, stream_of


def warp_plain(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch warp with `_warp_quad`'s arithmetic: float32
    coordinates, weights and lerp in the image dtype."""
    b, h, w, c = image.shape
    dt = image.dtype
    f = flow.float()
    grid_y = torch.arange(h, dtype=torch.float32, device=image.device).view(1, h, 1)
    grid_x = torch.arange(w, dtype=torch.float32, device=image.device).view(1, 1, w)
    query_y = grid_y - f[..., 0]
    query_x = grid_x - f[..., 1]
    floor_y = torch.clamp(torch.floor(query_y), 0.0, h - 2)
    floor_x = torch.clamp(torch.floor(query_x), 0.0, w - 2)
    alpha_y = torch.clamp(query_y - floor_y, 0.0, 1.0).to(dt)[..., None]
    alpha_x = torch.clamp(query_x - floor_x, 0.0, 1.0).to(dt)[..., None]
    boff = (torch.arange(b, device=image.device) * (h * w)).view(b, 1, 1)
    lin = boff + floor_y.long() * w + floor_x.long()
    flat = image.reshape(b * h * w, c)

    def tap(offset):
        return flat[(lin + offset).reshape(-1)].reshape(b, h, w, c)

    top_left, top_right, bottom_left, bottom_right = tap(0), tap(1), tap(w), tap(w + 1)
    interp_top = alpha_x * (top_right - top_left) + top_left
    interp_bottom = alpha_x * (bottom_right - bottom_left) + bottom_left
    return alpha_y * (interp_bottom - interp_top) + interp_top


def dense_image_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp a (B, H, W, C) image by a (B, H, W, 2) flow.

    A CPU tensor takes `warp_plain`. A CUDA tensor launches the kernel of
    csrc/warp.cu (image and flow both float32 or both bfloat16, both
    contiguous, H and W >= 2) and counts the launch in
    `dense_image_warp.launches`; anything the kernel does not take raises.
    """
    if image.device.type == "cpu" and flow.device.type == "cpu":
        return warp_plain(image, flow)
    if image.device.type != "cuda" or flow.device != image.device:
        raise ValueError(f"dense_image_warp: image on {image.device}, flow on "
                         f"{flow.device}; both must be on one CUDA device")
    if image.dim() != 4 or tuple(flow.shape) != (*image.shape[:3], 2):
        raise ValueError(f"dense_image_warp: image {tuple(image.shape)} and flow "
                         f"{tuple(flow.shape)} must be (B, H, W, C) and (B, H, W, 2)")
    if image.dtype not in DTYPE_CODES or flow.dtype != image.dtype:
        raise TypeError(f"dense_image_warp: dtypes {image.dtype}, {flow.dtype}; "
                        "need both float32 or both bfloat16")
    if not (image.is_contiguous() and flow.is_contiguous()):
        raise ValueError("dense_image_warp: inputs must be contiguous")
    b, h, w, c = image.shape
    if h < 2 or w < 2:
        raise ValueError(f"dense_image_warp: H={h}, W={w}; both must be >= 2")
    out = torch.empty_like(image)
    if out.numel() == 0:
        return out
    lib = library()
    lib.check(lib.lib.udt_warp(
        image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c,
        DTYPE_CODES[image.dtype], stream_of(image)), "warp")
    dense_image_warp.launches += 1
    return out


dense_image_warp.launches = 0
