"""Seeded weights of the three nets, made on the device in one draw.

The parameter names and shapes are the plain reference's, which are the
program's state-dict names (bench_port/reference/ mirrors models/*.py), so
the same tensors load into both. Kernels are normal with He scale in
PWC-Net's convolutions (leaky ReLU) and Glorot scale elsewhere; biases,
batch-norm affines and statistics are small random values, so that every
leaf matters. The generator's last kernel is scaled by `head` so that the
mask spans [0, 1] and its gradients do not vanish (as chip_smoke.py's
`train_weights` scales its flax-layout weights).
"""

from __future__ import annotations

import math

import torch

from ..reference.model import nets as reference_nets

GENERATOR_HEAD = "conv17.weight"


def _scale(net: str, name: str, shape) -> tuple[float, float]:
    """(mean, std) of one leaf's draw."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 4:
        rf = shape[2] * shape[3]
        if net == "pwc" and not name.startswith("up_"):
            return 0.0, math.sqrt(2.0 / (shape[1] * rf))
        return 0.0, math.sqrt(2.0 / ((shape[0] + shape[1]) * rf))
    return {"bias": (0.0, 0.01), "bn_gamma": (1.0, 0.1), "bn_beta": (0.0, 0.1),
            "bn_moving_mean": (0.0, 0.1), "bn_moving_variance": (1.0, 0.1)}[leaf]


def make(cfg: dict, seed: int, device, which=("generator", "recover", "pwc"),
         head: float = 30.0) -> dict:
    """{net: state dict} of the nets in `which`, float32 on `device`, from
    one normal draw of a `torch.Generator` on `device` seeded by `seed`."""
    templates = reference_nets(cfg, "cpu")
    leaves = [(net, name, t.shape) for net in which
              for name, t in templates[net].state_dict().items()]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, _, shape in leaves)
    noise = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: dict = {net: {} for net in which}
    offset = 0
    for net, name, shape in leaves:
        n = math.prod(shape)
        mean, std = _scale(net, name, shape)
        x = noise[offset:offset + n].view(shape) * std + mean
        if name.endswith("bn_moving_variance"):
            x = x.abs()
        if net == "generator" and name == GENERATOR_HEAD:
            x = x * head
        out[net][name] = x
        offset += n
    return out
