"""PWC cost volume: CUDA kernel wrappers, their plain PyTorch versions and
the autograd Function that joins them.

Counterpart of unsupervised_detection_tpu/ops/cost_volume.py (`cost_volume`,
`_cost_volume_xla`) and of the Pallas kernel
ops/pallas/cost_volume_kernel.py. For each displacement (dy, dx) of the
(2r+1)^2 window, in row-major order, the cost is the channel mean of
c1 * warp shifted by (dy-r, dx-r) with zero padding, then LeakyReLU(0.1)
(reference core_costvol.py:20-40). NHWC in, (B, H, W, (2r+1)^2) out.

The gradient is the VJP of `_cost_volume_xla`, which XLA derives in the JAX
package; the port computes it in `cost_volume_backward` (the kernel of
csrc/cost_volume_backward.cu on the card, `cost_volume_backward_plain` on
the CPU). `cost_volume` wraps both directions in one `torch.autograd.Function`,
so its output carries a gradient wherever an input requires one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import DTYPE_CODES, library, stream_of

SEARCH_RANGES = (2, 4)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 accumulation, float64 for float64 inputs (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def cost_volume_plain(c1: torch.Tensor, warp: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """Plain PyTorch cost volume: float32 products and sums, output in the
    input dtype."""
    r = search_range
    b, h, w, c = c1.shape
    acc = _acc_dtype(c1)
    a = c1.to(acc)
    padded = F.pad(warp.to(acc), (0, 0, r, r, r, r))
    costs = [(a * padded[:, dy:dy + h, dx:dx + w]).sum(dim=3) * (1.0 / c)
             for dy in range(2 * r + 1) for dx in range(2 * r + 1)]
    return F.leaky_relu(torch.stack(costs, dim=3), 0.1).to(c1.dtype)


def cost_volume_backward_plain(c1: torch.Tensor, warp: torch.Tensor, out: torch.Tensor,
                               g: torch.Tensor, search_range: int = 4):
    """(g_c1, g_warp), the VJP of the cost volume at (c1, warp) for the
    output gradient `g`, given the forward's output `out`:

        g'         = g * (1 if out >= 0 else 0.1)   (JAX's leaky_relu: slope 1 at 0)
        g_c1[p]    = (1/C) sum_k g'[p, k] * warp[p + d_k]
        g_warp[q]  = (1/C) sum_k g'[q - d_k, k] * c1[q - d_k]

    with d_k = (dy - r, dx - r) and zero padding. float32 sums, outputs in
    the input dtype."""
    r = search_range
    b, h, w, c = c1.shape
    acc = _acc_dtype(c1)
    gs = g.to(acc)
    gs = torch.where(out >= 0, gs, gs * 0.1) * (1.0 / c)
    a = c1.to(acc)
    padded = F.pad(warp.to(acc), (0, 0, r, r, r, r))
    g_c1 = torch.zeros_like(a)
    g_padded = torch.zeros_like(padded)
    k = 0
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            gk = gs[..., k:k + 1]
            g_c1 += gk * padded[:, dy:dy + h, dx:dx + w]
            g_padded[:, dy:dy + h, dx:dx + w] += gk * a
            k += 1
    g_warp = g_padded[:, r:r + h, r:r + w]
    return g_c1.to(c1.dtype), g_warp.to(warp.dtype).contiguous()


def _check_cuda(name: str, tensors: dict, search_range: int) -> None:
    """Raise unless the kernels take these tensors: one CUDA device, one
    dtype (float32 or bfloat16), contiguous, r in SEARCH_RANGES."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda" or any(t.device != first.device for t in tensors.values()):
        raise ValueError(f"{name}: " + ", ".join(f"{k} on {t.device}" for k, t in tensors.items())
                         + "; all must be on one CUDA device")
    if first.dtype not in DTYPE_CODES or any(t.dtype != first.dtype for t in tensors.values()):
        raise TypeError(f"{name}: dtypes " + ", ".join(str(t.dtype) for t in tensors.values())
                        + "; need all float32 or all bfloat16")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError(f"{name}: inputs must be contiguous NHWC")
    if search_range not in SEARCH_RANGES:
        raise ValueError(f"{name}: search_range {search_range} not in {SEARCH_RANGES}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_shapes(name: str, c1: torch.Tensor, warp: torch.Tensor) -> None:
    if c1.dim() != 4 or c1.shape != warp.shape:
        raise ValueError(f"{name}: shapes {tuple(c1.shape)} and {tuple(warp.shape)} "
                         "must be equal (B, H, W, C)")


def cost_volume_forward(c1: torch.Tensor, warp: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """The cost volume without autograd: `cost_volume_plain` on CPU tensors;
    on CUDA tensors the kernel of csrc/cost_volume.cu (float32 or bfloat16,
    contiguous NHWC, r in {2, 4}), counted in `cost_volume.launches`;
    anything the kernel does not take raises."""
    _check_shapes("cost_volume", c1, warp)
    if _on_cpu(c1, warp):
        return cost_volume_plain(c1, warp, search_range)
    _check_cuda("cost_volume", {"c1": c1, "warp": warp}, search_range)
    b, h, w, c = c1.shape
    k = (2 * search_range + 1) ** 2
    out = torch.empty((b, h, w, k), dtype=c1.dtype, device=c1.device)
    if out.numel() == 0:
        return out
    lib = library()
    lib.check(lib.lib.udt_cost_volume(
        c1.data_ptr(), warp.data_ptr(), out.data_ptr(), b, h, w, c,
        search_range, DTYPE_CODES[c1.dtype], stream_of(c1)), "cost_volume")
    cost_volume.launches += 1
    return out


def cost_volume_backward(c1: torch.Tensor, warp: torch.Tensor, out: torch.Tensor,
                         g: torch.Tensor, search_range: int = 4):
    """(g_c1, g_warp) of the cost volume: `cost_volume_backward_plain` on CPU
    tensors; on CUDA tensors the kernel of csrc/cost_volume_backward.cu (all
    four of one dtype, contiguous), counted in
    `cost_volume_backward.launches`; anything the kernel does not take
    raises."""
    _check_shapes("cost_volume_backward", c1, warp)
    k = (2 * search_range + 1) ** 2
    if tuple(out.shape) != (*c1.shape[:3], k) or out.shape != g.shape:
        raise ValueError(f"cost_volume_backward: out {tuple(out.shape)} and g "
                         f"{tuple(g.shape)} must be (B, H, W, {k})")
    if _on_cpu(c1, warp, out, g):
        return cost_volume_backward_plain(c1, warp, out, g, search_range)
    _check_cuda("cost_volume_backward", {"c1": c1, "warp": warp, "out": out, "g": g},
                search_range)
    b, h, w, c = c1.shape
    g_c1, g_warp = torch.empty_like(c1), torch.empty_like(warp)
    if g_c1.numel() == 0:
        return g_c1, g_warp
    lib = library()
    lib.check(lib.lib.udt_cost_volume_backward(
        c1.data_ptr(), warp.data_ptr(), out.data_ptr(), g.data_ptr(), g_c1.data_ptr(),
        g_warp.data_ptr(), b, h, w, c, search_range, DTYPE_CODES[c1.dtype], stream_of(c1)),
        "cost_volume_backward")
    cost_volume_backward.launches += 1
    return g_c1, g_warp


class _CostVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c1, warp, search_range):
        out = cost_volume_forward(c1, warp, search_range)
        ctx.save_for_backward(c1, warp, out)
        ctx.search_range = search_range
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        c1, warp, out = ctx.saved_tensors
        g_c1, g_warp = cost_volume_backward(c1, warp, out, g.contiguous(), ctx.search_range)
        return g_c1, g_warp, None


def cost_volume(c1: torch.Tensor, warp: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """Cost volume of two (B, H, W, C) feature maps, differentiable in both.

    CPU tensors take the plain versions both ways. CUDA tensors launch the
    forward kernel (counted in `cost_volume.launches`) and, in the backward
    pass, the backward kernel (`cost_volume_backward.launches`); anything
    the kernels do not take raises. A second derivative raises. Where no
    gradient is wanted (no input requires one, or grad mode is off) the
    forward runs without the Function's bookkeeping."""
    if torch.is_grad_enabled() and (c1.requires_grad or warp.requires_grad):
        return _CostVolume.apply(c1, warp, search_range)
    return cost_volume_forward(c1, warp, search_range)


cost_volume.launches = 0
cost_volume_backward.launches = 0
