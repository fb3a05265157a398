"""Carry the JAX package's flax parameter trees into the port's state dicts.

`from_jax_params(gen_params, gen_stats, pwc_params)` takes the flax trees as
nested dicts of numpy arrays (e.g. from `jax.device_get` on the JAX side;
this module imports no JAX) and returns `(gen_state_dict, pwc_state_dict)`
for `GeneratorNet` and `PWCNet`:

* conv kernels HWIO (kh, kw, in, out) -> OIHW (out, in, kh, kw);
* transposed-conv kernels, stored TF-style [kh, kw, out, in]
  (models/layers.py:215-265) -> PyTorch's (in, out, kh, kw);
* generator BN gamma/beta (params) and frozen moving statistics
  (batch_stats) -> the GenConv parameters and buffers;
* the flax module names become the dotted state-dict names; the
  `_PartsConvCore` scope "Conv_0" and GenDeconv's inner "conv" scope drop.

`random_jax_params` makes seeded random trees in the same flax layout with
numpy, for runs that need full-width weights without a checkpoint.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models import GeneratorNet, PWCNet
from .models.layers import ConvTranspose2D, GenConv, PWCConv


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def hwio_to_oihw(kernel) -> torch.Tensor:
    return _tensor(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def tf_transpose_kernel_to_torch(kernel) -> torch.Tensor:
    """[kh, kw, out, in] -> (in, out, kh, kw): the same axis permutation as
    HWIO -> OIHW."""
    return hwio_to_oihw(kernel)


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def pwc_state_dict(pwc_params: Mapping) -> dict[str, torch.Tensor]:
    out = {}
    for (*scopes, leaf), value in _leaves(pwc_params):
        is_kernel = leaf == "kernel"
        if scopes[-1] == "Conv_0":          # PWCConv's _PartsConvCore
            scopes = scopes[:-1]
            t = hwio_to_oihw(value) if is_kernel else _tensor(value)
        else:                               # ConvTranspose2D (up_flow*, up_feat*)
            t = tf_transpose_kernel_to_torch(value) if is_kernel else _tensor(value)
        out[".".join(scopes) + (".weight" if is_kernel else ".bias")] = t
    return out


def generator_state_dict(gen_params: Mapping, gen_stats: Mapping) -> dict[str, torch.Tensor]:
    out = {}
    for name, node in gen_params.items():
        stats = gen_stats[name]
        if "bn_gamma" not in node:          # GenDeconv wraps its GenConv as "conv"
            node, stats = node["conv"], stats["conv"]
        out[f"{name}.weight"] = hwio_to_oihw(node["conv"]["kernel"])
        out[f"{name}.bias"] = _tensor(node["conv"]["bias"])
        out[f"{name}.bn_gamma"] = _tensor(node["bn_gamma"])
        out[f"{name}.bn_beta"] = _tensor(node["bn_beta"])
        out[f"{name}.bn_moving_mean"] = _tensor(stats["bn_moving_mean"])
        out[f"{name}.bn_moving_variance"] = _tensor(stats["bn_moving_variance"])
    return out


def from_jax_params(gen_params: Mapping, gen_stats: Mapping, pwc_params: Mapping):
    """(gen_state_dict, pwc_state_dict) from the flax trees."""
    return generator_state_dict(gen_params, gen_stats), pwc_state_dict(pwc_params)


def _set(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def random_jax_params(generator: GeneratorNet, pwc: PWCNet, seed: int = 0):
    """Seeded random (gen_params, gen_stats, pwc_params) in the flax layout,
    shaped after the given port modules: he-normal PWC kernels,
    glorot-uniform generator and transposed-conv kernels, small random
    biases and BN affines/statistics (so every mapped leaf matters)."""
    rs = np.random.RandomState(seed)

    def f32(a):
        return np.asarray(a, dtype=np.float32)

    def glorot(shape, fan_in, fan_out):
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return f32(rs.uniform(-limit, limit, shape))

    gen_params, gen_stats = {}, {}
    for name, m in generator.named_children():
        if not isinstance(m, GenConv):
            continue
        o, i, kh, kw = m.weight.shape
        node = {"conv": {"kernel": glorot((kh, kw, i, o), kh * kw * i, kh * kw * o),
                         "bias": f32(0.01 * rs.randn(o))},
                "bn_gamma": f32(1.0 + 0.1 * rs.randn(o)),
                "bn_beta": f32(0.1 * rs.randn(o))}
        stats = {"bn_moving_mean": f32(0.1 * rs.randn(o)),
                 "bn_moving_variance": f32(1.0 + 0.1 * rs.rand(o))}
        if m.nn2_upsample:
            node, stats = {"conv": node}, {"conv": stats}
        gen_params[name], gen_stats[name] = node, stats

    pwc_params: dict = {}
    for name, m in pwc.named_modules():
        path = tuple(name.split("."))
        if isinstance(m, PWCConv):
            o, i, kh, kw = m.weight.shape
            std = np.sqrt(2.0 / (kh * kw * i))
            _set(pwc_params, path + ("Conv_0", "kernel"), f32(std * rs.randn(kh, kw, i, o)))
            _set(pwc_params, path + ("Conv_0", "bias"), f32(0.01 * rs.randn(o)))
        elif isinstance(m, ConvTranspose2D):
            i, o, kh, kw = m.weight.shape
            _set(pwc_params, path + ("kernel",), glorot((kh, kw, o, i), kh * kw * i, kh * kw * o))
            _set(pwc_params, path + ("bias",), f32(0.01 * rs.randn(o)))
    return gen_params, gen_stats, pwc_params
