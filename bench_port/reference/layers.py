"""NN primitives of the plain reference, frozen from the port's
models/layers.py: float32 activations and parameters throughout. The layers hold no
initialiser: the reference always loads the benchmark's weights.

Every convolution passes its input and its kernel through the layer's
`quant`, which is the identity in the reference and rounds them to a lower
precision in the control (bench_port/reference/quant.py): the step to TF32
or fp8 that a faster program would take. Activations are NCHW tensors. Convolutions use TF `SAME` padding, which is
asymmetric for strided convolutions on even inputs (0/1 for k3s2, 1/2 for
k5s2, 2/3 for k7s2); `padding=k//2` would be wrong there. State-dict names
follow the flax parameter names (convert.py maps one onto the other).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resize import resize_bilinear

BN_EPSILON = 1e-3  # tf.layers.batch_normalization default


def same_pads(in_size: int, kernel: int, stride: int, rate: int) -> tuple[int, int]:
    """(before, after) TF SAME padding along one axis."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + (kernel - 1) * rate + 1 - in_size, 0)
    return total // 2, total - total // 2


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                stride: int = 1, rate: int = 1, quant=_identity) -> torch.Tensor:
    """F.conv2d with TF SAME padding on quant(x) and quant(weight); weight
    is OIHW."""
    k = weight.shape[2]
    ph = same_pads(x.shape[2], k, stride, rate)
    pw = same_pads(x.shape[3], k, stride, rate)
    x, weight = quant(x), quant(weight)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, bias, stride, (ph[0], pw[0]), rate)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, bias, stride, 0, rate)


def nn2_subpixel_conv3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       quant=_identity) -> torch.Tensor:
    """3x3 SAME conv of the x2 nearest-neighbor upsample of x, without the
    upsample (counterpart of `_NN2SubpixelConv3`, models/layers.py:39-92).

    The x2 NN upsample (align_corners=True) replicates pixels, so per output
    parity (di, dj) the 3x3 conv collapses to a 2x2 conv over the original
    grid whose kernel sums adjacent taps: rows [K0, K1+K2] padded on top for
    di=0, [K0+K1, K2] padded at the bottom for di=1 (columns likewise). The
    four parity outputs interleave into the 2x image.
    """
    def collapse(k, parity, dim):
        k0, k1, k2 = k.unbind(dim)
        pair = (k0, k1 + k2) if parity == 0 else (k0 + k1, k2)
        return torch.stack(pair, dim)

    x = quant(x)
    rows = []
    for di in (0, 1):
        cols = []
        for dj in (0, 1):
            k2x2 = quant(collapse(collapse(weight, di, 2), dj, 3))
            xp = F.pad(x, (1 - dj, dj, 1 - di, di))
            cols.append(F.conv2d(xp, k2x2, bias))
        rows.append(torch.stack(cols, dim=-1))         # (B, C, h, w, 2)
    z = torch.stack(rows, dim=3)                       # (B, C, h, 2, w, 2)
    b, c, h, _, w, _ = z.shape
    return z.reshape(b, c, 2 * h, 2 * w)


class PWCConv(nn.Module):
    """Conv + LeakyReLU(0.1) (the port's `PWCConv`): callers pass the
    concatenated input channels."""

    quant = staticmethod(_identity)

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, rate: int = 1, activation: bool = True):
        super().__init__()
        self.stride, self.rate, self.activation = stride, rate, activation
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.weight, self.bias, self.stride, self.rate, self.quant)
        return F.leaky_relu(y, 0.1) if self.activation else y


class ConvTranspose2D(nn.Module):
    """tf.layers.conv2d_transpose with SAME padding (counterpart of
    `ConvTranspose2D`, models/layers.py:215-265). The TF kernel
    [kh, kw, out, in] is stored in PyTorch's (in, out, kh, kw) layout;
    SAME output is in * stride, i.e. padding (k - stride) / 2."""

    quant = staticmethod(_identity)

    def __init__(self, in_ch: int, features: int, kernel_size: int = 4, stride: int = 2):
        super().__init__()
        if (kernel_size - stride) % 2:
            raise ValueError("SAME transposed conv needs kernel_size - stride even")
        self.stride, self.padding = stride, (kernel_size - stride) // 2
        self.weight = nn.Parameter(torch.empty(in_ch, features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(self.quant(x), self.quant(self.weight), self.bias,
                                  self.stride, self.padding)


class GenConv(nn.Module):
    """Conv + inference-mode BatchNorm + ELU (counterpart of `GenConv`,
    models/layers.py:95-152). The BN statistics are frozen buffers
    (0 and 1 unless loaded), gamma and beta are parameters; the BN affine is
    folded in float32. `nn2_upsample=True` convolves the x2 NN upsample of the input via
    `nn2_subpixel_conv3` (kernel 3, stride 1, rate 1 only)."""

    quant = staticmethod(_identity)

    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int = 1,
                 rate: int = 1, activation: bool = True, nn2_upsample: bool = False):
        super().__init__()
        if nn2_upsample and (kernel_size, stride, rate) != (3, 1, 1):
            raise ValueError("nn2_upsample needs kernel 3, stride 1, rate 1")
        self.stride, self.rate = stride, rate
        self.activation, self.nn2_upsample = activation, nn2_upsample
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        self.bn_gamma = nn.Parameter(torch.ones(features))
        self.bn_beta = nn.Parameter(torch.zeros(features))
        self.register_buffer("bn_moving_mean", torch.zeros(features))
        self.register_buffer("bn_moving_variance", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.nn2_upsample:
            y = nn2_subpixel_conv3(x, self.weight, self.bias, self.quant)
        else:
            y = conv2d_same(x, self.weight, self.bias, self.stride, self.rate, self.quant)
        inv = torch.rsqrt(self.bn_moving_variance + BN_EPSILON)
        scale = self.bn_gamma * inv
        shift = self.bn_beta - self.bn_moving_mean * self.bn_gamma * inv
        y = y * scale[:, None, None] + shift[:, None, None]
        return F.elu(y) if self.activation else y


class GenDeconv(GenConv):
    """x2 nearest-neighbor upsample (align_corners=True) + GenConv 3x3
    (counterpart of `GenDeconv`, models/layers.py:155-167)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(in_ch, features, 3, nn2_upsample=True)


class BiasedConv(nn.Module):
    """Conv + bias + LeakyReLU(0.2) (counterpart of
    `BiasedConv`, models/layers.py:170-193; the recover net's block).
    TF SAME padding; `activation=False` leaves the conv linear."""

    quant = staticmethod(_identity)

    def __init__(self, in_ch: int, features: int, kernel_size: int, stride: int = 1,
                 activation: bool = True):
        super().__init__()
        self.stride, self.activation = stride, activation
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.weight, self.bias, self.stride, 1, self.quant)
        return F.leaky_relu(y, 0.2) if self.activation else y


class ResizeConv(BiasedConv):
    """TF1-legacy bilinear resize to `size`, then a stride-1 BiasedConv
    (counterpart of `ResizeConv`, models/layers.py:196-212). The default
    kernel 4 is even, so TF SAME pads it 1 before and 2 after."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 4,
                 activation: bool = True):
        super().__init__(in_ch, features, kernel_size, 1, activation)

    def forward(self, x: torch.Tensor, size) -> torch.Tensor:
        x = resize_bilinear(x.permute(0, 2, 3, 1), size).permute(0, 3, 1, 2)
        return super().forward(x)


def set_quant(net: nn.Module, quant) -> nn.Module:
    """Give every convolution of `net` the rounding `quant` (None: none)."""
    for m in net.modules():
        if isinstance(m, (PWCConv, ConvTranspose2D, GenConv, BiasedConv)):
            m.quant = _identity if quant is None else quant
    return net
