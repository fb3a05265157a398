"""Tile copy at an offset held on the device: CUDA kernel wrapper and its
plain PyTorch version.

Counterpart of the Pallas kernel in tools/repro_mosaic_dynamic_dma.py
(`build`), a compiler repro on no path of the system. It copies a 128x256
float32 tile out of a (1024, 256) buffer (axis 0) or a (128, 1024) buffer
(axis 1) starting at offs[0] * STEPS[axis] along `axis`, where `offs` is an
int32 tensor. A negative start counts from the end and the tile is clamped
into the buffer, as in lax.dynamic_slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ._build import library, stream_of

TILE = (128, 256)
STEPS = (8, 256)   # the repro's offset multiplier per axis


def _start(offset: int, src: torch.Tensor, axis: int) -> int:
    """lax.dynamic_slice's start: a negative one counts from the end, then
    the tile is clamped into the buffer."""
    start = offset * STEPS[axis]
    if start < 0:
        start += src.shape[axis]
    return min(max(start, 0), src.shape[axis] - TILE[axis])


def dynamic_copy_plain(offs: torch.Tensor, src: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain PyTorch version: the slice (reads the offset on the host)."""
    return src.narrow(axis, _start(int(offs[0]), src, axis), TILE[axis]).clone()


def dynamic_copy(offs: torch.Tensor, src: torch.Tensor, axis: int) -> torch.Tensor:
    """The (128, 256) tile of `src` at offset offs[0] * STEPS[axis] along `axis`.

    A CPU tensor takes `dynamic_copy_plain`. A CUDA tensor launches the
    kernel of csrc/dynamic_copy.cu (src float32, contiguous, 16-byte aligned;
    offs int32 on the same device; the offset stays on the device) and
    counts the launch in `dynamic_copy.launches`; anything the kernel does
    not take raises.
    """
    if axis not in (0, 1):
        raise ValueError(f"dynamic_copy: axis {axis} not in (0, 1)")
    if src.device.type == "cpu" and offs.device.type == "cpu":
        return dynamic_copy_plain(offs, src, axis)
    if src.device.type != "cuda" or offs.device != src.device:
        raise ValueError(f"dynamic_copy: src on {src.device}, offs on {offs.device}; "
                         "both must be on one CUDA device")
    if src.dtype != torch.float32 or offs.dtype != torch.int32 or offs.numel() < 1:
        raise TypeError(f"dynamic_copy: src {src.dtype}, offs {offs.dtype} "
                        f"({offs.numel()} values); need float32 and at least one int32")
    other = 1 - axis
    if (src.dim() != 2 or src.shape[other] != TILE[other] or src.shape[axis] < TILE[axis]
            or src.shape[1] % 4 or not src.is_contiguous() or src.data_ptr() % 16):
        raise ValueError(f"dynamic_copy: src {tuple(src.shape)} along axis {axis} must be "
                         f"contiguous, 16-byte aligned, {TILE[other]} wide in dim {other} "
                         f"and at least {TILE[axis]} in dim {axis}")
    out = torch.empty(TILE, dtype=src.dtype, device=src.device)
    lib = library()
    lib.check(lib.lib.udt_dynamic_copy(
        src.data_ptr(), offs.contiguous().data_ptr(), out.data_ptr(), src.shape[0],
        src.shape[1], axis, STEPS[axis], stream_of(src)), "dynamic_copy")
    dynamic_copy.launches += 1
    return out


dynamic_copy.launches = 0


def repro(device=None, seed: int = 0) -> dict[str, bool]:
    """The repro's `main` on the port: for the lane case (axis 1) and then
    the sublane case (axis 0), copy the tile at offset 2 from a seeded
    random buffer and compare it with the numpy slice the repro expects.
    Returns {case: bit-equal}."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    result = {}
    for axis, name in ((1, "lane"), (0, "sublane")):
        shape = (1024, 256) if axis == 0 else (128, 1024)
        src = rng.rand(*shape).astype(np.float32)
        got = dynamic_copy(torch.tensor([2], dtype=torch.int32, device=dev),
                           torch.from_numpy(src).to(dev), axis)
        start = 2 * STEPS[axis]
        want = src[start:start + 128, :] if axis == 0 else src[:, start:start + 256]
        result[name] = bool(np.array_equal(got.cpu().numpy(), want))
    return result
