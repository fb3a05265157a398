"""PWC cost volume: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of unsupervised_detection_tpu/ops/cost_volume.py (`cost_volume`,
`_cost_volume_xla`) and of the Pallas kernel
ops/pallas/cost_volume_kernel.py. For each displacement (dy, dx) of the
(2r+1)^2 window, in row-major order, the cost is the channel mean of
c1 * warp shifted by (dy-r, dx-r) with zero padding, then LeakyReLU(0.1)
(reference core_costvol.py:20-40). NHWC in, (B, H, W, (2r+1)^2) out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import DTYPE_CODES, library, stream_of

SEARCH_RANGES = (2, 4)


def cost_volume_plain(c1: torch.Tensor, warp: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """Plain PyTorch cost volume: float32 products and sums, output in the
    input dtype."""
    r = search_range
    b, h, w, c = c1.shape
    a = c1.float()
    padded = F.pad(warp.float(), (0, 0, r, r, r, r))
    costs = [(a * padded[:, dy:dy + h, dx:dx + w]).sum(dim=3) * (1.0 / c)
             for dy in range(2 * r + 1) for dx in range(2 * r + 1)]
    return F.leaky_relu(torch.stack(costs, dim=3), 0.1).to(c1.dtype)


def cost_volume(c1: torch.Tensor, warp: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """Cost volume of two (B, H, W, C) feature maps.

    A CPU tensor takes `cost_volume_plain`. A CUDA tensor launches the kernel
    of csrc/cost_volume.cu (float32 or bfloat16, contiguous NHWC, r in
    {2, 4}) and counts the launch in `cost_volume.launches`; anything the
    kernel does not take raises.
    """
    if c1.device.type == "cpu" and warp.device.type == "cpu":
        return cost_volume_plain(c1, warp, search_range)
    if c1.device.type != "cuda" or warp.device != c1.device:
        raise ValueError(f"cost_volume: c1 on {c1.device}, warp on {warp.device}; "
                         "both must be on one CUDA device")
    if c1.dim() != 4 or c1.shape != warp.shape:
        raise ValueError(f"cost_volume: shapes {tuple(c1.shape)} and {tuple(warp.shape)} "
                         "must be equal (B, H, W, C)")
    if c1.dtype not in DTYPE_CODES or warp.dtype != c1.dtype:
        raise TypeError(f"cost_volume: dtypes {c1.dtype}, {warp.dtype}; "
                        "need both float32 or both bfloat16")
    if not (c1.is_contiguous() and warp.is_contiguous()):
        raise ValueError("cost_volume: inputs must be contiguous NHWC")
    if search_range not in SEARCH_RANGES:
        raise ValueError(f"cost_volume: search_range {search_range} not in {SEARCH_RANGES}")
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


cost_volume.launches = 0
