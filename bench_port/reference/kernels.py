"""The plain versions of PWC-Net's two custom operations and of their
gradients, frozen here from the port's ops/cost_volume.py and ops/warp.py
(`cost_volume_plain`, `cost_volume_backward_plain`, `warp_plain`,
`warp_backward_plain`), joined into autograd Functions. Float32 products
and sums; no kernel of the program is called.

Cost volume: for each displacement (dy, dx) of the (2r+1)^2 window, in
row-major order, the channel mean of c1 * warp shifted by (dy-r, dx-r)
with zero padding, then LeakyReLU(0.1) (the reference's core_costvol.py).
Warp: output(b, y, x) = image(b, y - flow_y, x - flow_x), bilinear, floors
clamped to [0, H-2] x [0, W-2], weights clamped to [0, 1], the lerp x first
then y (core_warp.py); flow channel 0 is y. Their gradients are the VJPs
that XLA derives for the JAX package: the leaky ReLU's slope is 1 at 0,
and the weight clamp passes half the gradient at exactly 0 or 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cost_volume_plain(c1: torch.Tensor, warp: torch.Tensor, r: int) -> torch.Tensor:
    b, h, w, c = c1.shape
    a = c1.float()
    padded = F.pad(warp.float(), (0, 0, r, r, r, r))
    costs = [(a * padded[:, dy:dy + h, dx:dx + w]).sum(dim=3) * (1.0 / c)
             for dy in range(2 * r + 1) for dx in range(2 * r + 1)]
    return F.leaky_relu(torch.stack(costs, dim=3), 0.1)


def cost_volume_backward_plain(c1, warp, out, g, r: int):
    """(g_c1, g_warp): g' = g * (1 if out >= 0 else 0.1) / C;
    g_c1[p] = sum_k g'[p, k] warp[p + d_k]; g_warp[q] = sum_k g'[q - d_k, k] c1[q - d_k]."""
    b, h, w, c = c1.shape
    gs = g.float()
    gs = torch.where(out >= 0, gs, gs * 0.1) * (1.0 / c)
    a = c1.float()
    padded = F.pad(warp.float(), (0, 0, r, r, r, r))
    g_c1 = torch.zeros_like(a)
    g_padded = torch.zeros_like(padded)
    k = 0
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            gk = gs[..., k:k + 1]
            g_c1 += gk * padded[:, dy:dy + h, dx:dx + w]
            g_padded[:, dy:dy + h, dx:dx + w] += gk * a
            k += 1
    return g_c1, g_padded[:, r:r + h, r:r + w].contiguous()


def _coords(image: torch.Tensor, flow: torch.Tensor):
    """(linear index of the top-left tap, raw fractions ry, rx, clamped
    weights ay, ax)."""
    b, h, w, _ = image.shape
    f = flow.float()
    grid_y = torch.arange(h, dtype=torch.float32, device=image.device).view(1, h, 1)
    grid_x = torch.arange(w, dtype=torch.float32, device=image.device).view(1, 1, w)
    query_y = grid_y - f[..., 0]
    query_x = grid_x - f[..., 1]
    floor_y = torch.clamp(torch.floor(query_y), 0.0, h - 2)
    floor_x = torch.clamp(torch.floor(query_x), 0.0, w - 2)
    ry, rx = query_y - floor_y, query_x - floor_x
    ay = torch.clamp(ry, 0.0, 1.0)[..., None]
    ax = torch.clamp(rx, 0.0, 1.0)[..., None]
    boff = (torch.arange(b, device=image.device) * (h * w)).view(b, 1, 1)
    return boff + floor_y.long() * w + floor_x.long(), ry, rx, ay, ax


def _taps(image: torch.Tensor, lin: torch.Tensor):
    b, h, w, c = image.shape
    flat = image.reshape(b * h * w, c).float()

    def tap(offset):
        return flat[(lin + offset).reshape(-1)].reshape(b, h, w, c)

    return tap(0), tap(1), tap(w), tap(w + 1)


def warp_plain(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    lin, _, _, ay, ax = _coords(image, flow)
    top_left, top_right, bottom_left, bottom_right = _taps(image, lin)
    interp_top = ax * (top_right - top_left) + top_left
    interp_bottom = ax * (bottom_right - bottom_left) + bottom_left
    return ay * (interp_bottom - interp_top) + interp_top


def _clip_grad(r: torch.Tensor) -> torch.Tensor:
    """d clip(r, 0, 1) / dr as JAX takes it: 1 inside, 0.5 at 0 or 1, 0 outside."""
    return ((r > 0) & (r < 1)).float() + 0.5 * ((r == 0) | (r == 1)).float()


def warp_backward_plain(image: torch.Tensor, flow: torch.Tensor, g: torch.Tensor):
    b, h, w, c = image.shape
    lin, ry, rx, ay, ax = _coords(image, flow)
    tl, tr, bl, br = _taps(image, lin)
    gg = g.float()
    ct_top, ct_bottom = gg * (1.0 - ay), gg * ay
    top = ax * (tr - tl) + tl
    bottom = ax * (br - bl) + bl
    g_ay = (gg * (bottom - top)).sum(dim=3)
    g_ax = (ct_top * (tr - tl) + ct_bottom * (br - bl)).sum(dim=3)
    g_flow = torch.stack([-g_ay * _clip_grad(ry), -g_ax * _clip_grad(rx)], dim=3)
    g_image = torch.zeros((b * h * w, c), dtype=torch.float32, device=image.device)
    idx = lin.reshape(-1)
    for offset, part in ((0, ct_top * (1.0 - ax)), (1, ct_top * ax),
                         (w, ct_bottom * (1.0 - ax)), (w + 1, ct_bottom * ax)):
        g_image.index_add_(0, idx + offset, part.reshape(-1, c))
    return g_image.reshape(b, h, w, c), g_flow


class _CostVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c1, warp, r):
        out = cost_volume_plain(c1, warp, r)
        ctx.save_for_backward(c1, warp, out)
        ctx.r = r
        return out

    @staticmethod
    def backward(ctx, g):
        c1, warp, out = ctx.saved_tensors
        g_c1, g_warp = cost_volume_backward_plain(c1, warp, out, g, ctx.r)
        return g_c1, g_warp, None


class _Warp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, flow):
        ctx.save_for_backward(image, flow)
        return warp_plain(image, flow)

    @staticmethod
    def backward(ctx, g):
        image, flow = ctx.saved_tensors
        return warp_backward_plain(image, flow, g)


def cost_volume(c1: torch.Tensor, warp: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C) x 2 -> (B, H, W, (2r+1)^2), differentiable in both."""
    if torch.is_grad_enabled() and (c1.requires_grad or warp.requires_grad):
        return _CostVolume.apply(c1, warp, r)
    return cost_volume_plain(c1, warp, r)


def dense_image_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp (B, H, W, C) by (B, H, W, 2), differentiable in both."""
    if torch.is_grad_enabled() and (image.requires_grad or flow.requires_grad):
        return _Warp.apply(image, flow)
    return warp_plain(image, flow)
