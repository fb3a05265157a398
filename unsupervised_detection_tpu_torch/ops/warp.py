"""Backward bilinear warp: CUDA kernel wrappers, their plain PyTorch
versions and the autograd Function that joins them.

Counterpart of unsupervised_detection_tpu/ops/warp.py (`_warp_quad` and the
Pallas-backed `_warp_window`): output(b, y, x) = image(b, y - flow_y,
x - flow_x), bilinear, with floors clamped to [0, H-2] x [0, W-2], weights
clamped to [0, 1] and the lerp in TF order, x first then y (reference
core_warp.py:94-150). Flow channel 0 is y.

The gradient is JAX's: the warp's `custom_vjp` takes the VJP of
`_warp_quad` (ops/warp.py:150-154 there), computed here by `warp_backward`
(the kernel of csrc/warp_backward.cu on the card, `warp_backward_plain` on
the CPU). It keeps JAX's rule at the weight clamp's ties: `jnp.clip` passes
half the gradient where a fraction is exactly 0 or 1 (every pixel under a
zero flow), where autograd of `torch.clamp` would pass all of it.
`dense_image_warp` wraps both directions in one `torch.autograd.Function`.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ._build import DTYPE_CODES, library, stream_of


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 coordinates and sums, float64 for float64 inputs (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _coords(image: torch.Tensor, flow: torch.Tensor):
    """`_tap_coords`: (linear index of the top-left tap (B, H, W), raw
    fractions ry, rx, weights ay, ax) in the accumulation dtype, the weights
    rounded to the image dtype as the forward rounds them."""
    b, h, w, _ = image.shape
    acc = _acc_dtype(image)
    f = flow.to(acc)
    grid_y = torch.arange(h, dtype=acc, device=image.device).view(1, h, 1)
    grid_x = torch.arange(w, dtype=acc, device=image.device).view(1, 1, w)
    query_y = grid_y - f[..., 0]
    query_x = grid_x - f[..., 1]
    floor_y = torch.clamp(torch.floor(query_y), 0.0, h - 2)
    floor_x = torch.clamp(torch.floor(query_x), 0.0, w - 2)
    ry, rx = query_y - floor_y, query_x - floor_x
    ay = torch.clamp(ry, 0.0, 1.0).to(image.dtype)[..., None]
    ax = torch.clamp(rx, 0.0, 1.0).to(image.dtype)[..., None]
    boff = (torch.arange(b, device=image.device) * (h * w)).view(b, 1, 1)
    lin = boff + floor_y.long() * w + floor_x.long()
    return lin, ry, rx, ay, ax


def _taps(image: torch.Tensor, lin: torch.Tensor, dtype: torch.dtype):
    """The four taps (top-left, top-right, bottom-left, bottom-right) in
    `dtype`, each (B, H, W, C)."""
    b, h, w, c = image.shape
    flat = image.reshape(b * h * w, c).to(dtype)

    def tap(offset):
        return flat[(lin + offset).reshape(-1)].reshape(b, h, w, c)

    return tap(0), tap(1), tap(w), tap(w + 1)


def warp_plain(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch warp with `_warp_quad`'s arithmetic: float32
    coordinates, weights and lerp in the image dtype."""
    lin, _, _, ay, ax = _coords(image, flow)
    top_left, top_right, bottom_left, bottom_right = _taps(image, lin, image.dtype)
    interp_top = ax * (top_right - top_left) + top_left
    interp_bottom = ax * (bottom_right - bottom_left) + bottom_left
    return ay * (interp_bottom - interp_top) + interp_top


def _clip_grad(r: torch.Tensor) -> torch.Tensor:
    """d clip(r, 0, 1) / dr as JAX takes it: 1 inside (0, 1), 0.5 at
    exactly 0 or 1, 0 outside."""
    inside = ((r > 0) & (r < 1)).to(r.dtype)
    tie = ((r == 0) | (r == 1)).to(r.dtype)
    return inside + 0.5 * tie


def warp_backward_plain(image: torch.Tensor, flow: torch.Tensor, g: torch.Tensor):
    """(g_image, g_flow), the VJP of `_warp_quad` at (image, flow) for the
    output gradient `g`: g_image scatter-adds g times the four bilinear
    weights onto the four taps; g_flow is minus the channel sums of g times
    d out / d(ay, ax), times the weight clamp's derivative (JAX's, with 0.5
    at the ties). float32 sums, outputs in the input dtypes."""
    b, h, w, c = image.shape
    acc = _acc_dtype(image)
    lin, ry, rx, ay, ax = _coords(image, flow)
    ay, ax = ay.to(acc), ax.to(acc)
    tl, tr, bl, br = _taps(image, lin, acc)
    gg = g.to(acc)
    ct_top, ct_bottom = gg * (1.0 - ay), gg * ay
    top = ax * (tr - tl) + tl
    bottom = ax * (br - bl) + bl
    g_ay = (gg * (bottom - top)).sum(dim=3)
    g_ax = (ct_top * (tr - tl) + ct_bottom * (br - bl)).sum(dim=3)
    g_flow = torch.stack([-g_ay * _clip_grad(ry), -g_ax * _clip_grad(rx)], dim=3)
    g_image = torch.zeros((b * h * w, c), dtype=acc, device=image.device)
    idx = lin.reshape(-1)
    for offset, part in ((0, ct_top * (1.0 - ax)), (1, ct_top * ax),
                         (w, ct_bottom * (1.0 - ax)), (w + 1, ct_bottom * ax)):
        g_image.index_add_(0, idx + offset, part.reshape(-1, c))
    return g_image.reshape(b, h, w, c).to(image.dtype), g_flow.to(flow.dtype)


def _check(name: str, image: torch.Tensor, flow: torch.Tensor, extra=()) -> bool:
    """True for CPU tensors (the plain versions); for CUDA tensors raise
    unless the kernels take them: one device, image and flow both float32
    or both bfloat16 (and `extra` alike), contiguous, H and W >= 2."""
    if image.dim() != 4 or tuple(flow.shape) != (*image.shape[:3], 2):
        raise ValueError(f"{name}: image {tuple(image.shape)} and flow "
                         f"{tuple(flow.shape)} must be (B, H, W, C) and (B, H, W, 2)")
    tensors = (image, flow, *extra)
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if image.device.type != "cuda" or any(t.device != image.device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}; "
                         "all must be on one CUDA device")
    if image.dtype not in DTYPE_CODES or any(t.dtype != image.dtype for t in tensors):
        raise TypeError(f"{name}: dtypes {[str(t.dtype) for t in tensors]}; "
                        "need all float32 or all bfloat16")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if image.shape[1] < 2 or image.shape[2] < 2:
        raise ValueError(f"{name}: H={image.shape[1]}, W={image.shape[2]}; both must be >= 2")
    return False


def warp_forward(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The warp without autograd: `warp_plain` on CPU tensors; on CUDA
    tensors the kernel of csrc/warp.cu, counted in
    `dense_image_warp.launches`; anything the kernel does not take raises."""
    if _check("dense_image_warp", image, flow):
        return warp_plain(image, flow)
    b, h, w, c = image.shape
    out = torch.empty_like(image)
    if out.numel() == 0:
        return out
    lib = library()
    lib.check(lib.lib.udt_warp(
        image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c,
        DTYPE_CODES[image.dtype], stream_of(image)), "warp")
    dense_image_warp.launches += 1
    return out


def warp_backward(image: torch.Tensor, flow: torch.Tensor, g: torch.Tensor):
    """(g_image, g_flow) of the warp: `warp_backward_plain` on CPU tensors;
    on CUDA tensors the kernel of csrc/warp_backward.cu (image, flow and g
    of one dtype, contiguous), counted in `warp_backward.launches`; anything
    the kernel does not take raises. The kernel scatters g_image with
    float32 atomics into a zeroed float32 buffer, cast here for bfloat16."""
    if g.shape != image.shape:
        raise ValueError(f"warp_backward: g {tuple(g.shape)} must be shaped like the "
                         f"image {tuple(image.shape)}")
    if _check("warp_backward", image, flow, (g,)):
        return warp_backward_plain(image, flow, g)
    b, h, w, c = image.shape
    g_image = torch.zeros(image.shape, dtype=torch.float32, device=image.device)
    g_flow = torch.empty_like(flow)
    if g_image.numel() == 0:
        return g_image.to(image.dtype), g_flow
    lib = library()
    lib.check(lib.lib.udt_warp_backward(
        image.data_ptr(), flow.data_ptr(), g.data_ptr(), g_image.data_ptr(), g_flow.data_ptr(),
        b, h, w, c, DTYPE_CODES[image.dtype], stream_of(image)), "warp_backward")
    warp_backward.launches += 1
    return g_image.to(image.dtype), g_flow


class _Warp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, flow):
        ctx.save_for_backward(image, flow)
        return warp_forward(image, flow)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        image, flow = ctx.saved_tensors
        return warp_backward(image, flow, g.contiguous())


def dense_image_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp a (B, H, W, C) image by a (B, H, W, 2) flow,
    differentiable in both.

    CPU tensors take the plain versions both ways. CUDA tensors (image and
    flow both float32 or both bfloat16, contiguous, H and W >= 2) launch the
    forward kernel (counted in `dense_image_warp.launches`) and, in the
    backward pass, the backward kernel (`warp_backward.launches`); anything
    the kernels do not take raises. A second derivative raises. Where no
    gradient is wanted (no input requires one, or grad mode is off) the
    forward runs without the Function's bookkeeping."""
    if torch.is_grad_enabled() and (image.requires_grad or flow.requires_grad):
        return _Warp.apply(image, flow)
    return warp_forward(image, flow)


dense_image_warp.launches = 0
warp_backward.launches = 0
