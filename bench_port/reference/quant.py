"""The controls' lower precisions: each rounds a convolution's operands as
the faster arithmetic would, so that the plain reference, put in the
program's place with one of them, computes what a program in that
precision would compute.

* `tf32`: the float32 mantissa rounded to TF32's 10 bits (to nearest,
  ties to even), as the tensor cores round float32 operands when TF32 is
  on; products and sums stay float32.
* `fp8`: e4m3 with one scale per tensor (its largest magnitude to 448),
  as an fp8 convolution takes its operands; products and sums float32.

Both are autograd Functions that round the gradient on its way back too,
as the backward convolutions of that precision would round their operands.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest finite float8_e4m3fn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def tf32(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x, round_tf32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x, round_fp8)


# the precision below each one a configuration may state
BELOW = {"float32": tf32, "bfloat16": fp8}
