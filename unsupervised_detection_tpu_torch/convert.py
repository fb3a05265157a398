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

The recover net's trees map the same way (`recover_state_dict`; the
`BiasedConv` scope "Conv_0" and `ResizeConv`'s inner "conv" scope drop),
and `from_jax_train_state` carries a whole JAX `TrainState` (both nets'
Adam moments, their counts and the step) into the port's training state.
One table, `flax_paths`, holds the name mapping: the maps above read the
trees by it, and `flax_trees` writes a port module's tensors back onto the
flax trees by it, for the port's own saves (train/checkpoint.py).

`random_jax_params` and `random_recover_params` make seeded random trees in
the same flax layout with numpy, for runs that need full-width weights
without a checkpoint.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .models import GeneratorNet, PWCNet, RecoverNet
from .models.layers import BiasedConv, ConvTranspose2D, GenConv, PWCConv, ResizeConv


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


def _skeleton(cls, **kwargs) -> nn.Module:
    """A port network on the meta device: its names without its memory."""
    with torch.device("meta"):
        return cls(**kwargs)


def state_dict_from_trees(net: nn.Module, trees: Mapping[str, Mapping | None]
                          ) -> dict[str, torch.Tensor]:
    """`net`'s state-dict entries from {collection: flax tree}: each name is
    read at `flax_paths(net)[name]`, 4-D kernels go HWIO -> OIHW (the
    transposed convs' TF layout takes the same permutation). A collection
    that is absent or None is skipped (a params-shaped Adam moment maps to
    the parameters' names); every leaf given must map to a name."""
    out = {}
    for name, (collection, *path) in flax_paths(net).items():
        tree = trees.get(collection)
        if tree is None:
            continue
        for key in path:
            if key not in tree:
                raise KeyError(f"{collection}/{'/'.join(path)} missing for {name}")
            tree = tree[key]
        out[name] = hwio_to_oihw(tree) if np.ndim(tree) == 4 else _tensor(tree)
    given = sum(1 for tree in trees.values() if tree is not None for _ in _leaves(tree))
    if given != len(out):
        raise ValueError(f"{given} flax leaves given, {len(out)} map to "
                         f"{type(net).__name__}'s names")
    return out


def pwc_state_dict(pwc_params: Mapping) -> dict[str, torch.Tensor]:
    """`PWCNet` state dict; its levels are read off the tree's estimators."""
    lvls = [int(k[len("estimator"):]) for k in pwc_params if k.startswith("estimator")]
    net = _skeleton(PWCNet, pyr_lvls=max(lvls), flow_pred_lvl=min(lvls))
    return state_dict_from_trees(net, {"params": pwc_params})


def generator_state_dict(gen_params: Mapping, gen_stats: Mapping | None = None
                         ) -> dict[str, torch.Tensor]:
    """The generator's parameters and, given `gen_stats`, its frozen BN
    statistics. A params-shaped tree alone (an Adam moment) maps to the
    parameters' names."""
    return state_dict_from_trees(_skeleton(GeneratorNet),
                                 {"params": gen_params, "batch_stats": gen_stats})


def recover_state_dict(rec_params: Mapping) -> dict[str, torch.Tensor]:
    """`RecoverNet` state dict (or a params-shaped Adam moment) from the
    flax tree."""
    return state_dict_from_trees(_skeleton(RecoverNet), {"params": rec_params})


def from_jax_params(gen_params: Mapping, gen_stats: Mapping, pwc_params: Mapping):
    """(gen_state_dict, pwc_state_dict) from the flax trees."""
    return generator_state_dict(gen_params, gen_stats), pwc_state_dict(pwc_params)


def from_jax_train_state(fields: Mapping) -> dict:
    """The port's training state from the fields of a JAX `TrainState`
    (train/learner.py:38-55) as nested dicts of numpy arrays: `step`, the
    three nets' state dicts (`gen`, `rec`, `pwc`) and both Adam states
    (`gen_opt`, `rec_opt`: `count` and the moments `m`, `v` keyed by the
    parameters' names). A game-arm save holds no PWC weights: `pwc` is then
    empty.

    JAX's `rng` key has no torch counterpart and is not carried over: the
    port draws its augmentation and gradient noise from its own
    `torch.Generator`, seeded from `Config.seed` (train/learner.py)."""
    def adam(opt, to_state_dict):
        return {"count": int(opt["count"]), "m": to_state_dict(opt["m"]),
                "v": to_state_dict(opt["v"])}

    pwc = fields.get("pwc_params") or {}
    return {"step": int(fields["step"]),
            "gen": generator_state_dict(fields["gen_params"], fields["gen_stats"]),
            "rec": recover_state_dict(fields["rec_params"]),
            "pwc": pwc_state_dict(pwc) if pwc else {},
            "gen_opt": adam(fields["gen_opt"], generator_state_dict),
            "rec_opt": adam(fields["rec_opt"], recover_state_dict)}


def flax_paths(net: nn.Module) -> dict[str, tuple[str, ...]]:
    """State-dict name -> (collection, *flax path) of every parameter and
    buffer of a port network; the collection is "params" or "batch_stats".
    The one table of the name mapping: `state_dict_from_trees` reads by it
    and `flax_trees` writes by it."""
    out = {}
    for name, m in net.named_modules():
        path = tuple(name.split("."))
        if isinstance(m, GenConv):
            if m.nn2_upsample:
                path += ("conv",)
            out[f"{name}.weight"] = ("params", *path, "conv", "kernel")
            out[f"{name}.bias"] = ("params", *path, "conv", "bias")
            for leaf in ("bn_gamma", "bn_beta"):
                out[f"{name}.{leaf}"] = ("params", *path, leaf)
            for leaf in ("bn_moving_mean", "bn_moving_variance"):
                out[f"{name}.{leaf}"] = ("batch_stats", *path, leaf)
        elif isinstance(m, (PWCConv, BiasedConv, ConvTranspose2D)):
            inner = {PWCConv: ("Conv_0",), BiasedConv: ("Conv_0",),
                     ResizeConv: ("conv", "Conv_0"), ConvTranspose2D: ()}[type(m)]
            out[f"{name}.weight"] = ("params", *path, *inner, "kernel")
            out[f"{name}.bias"] = ("params", *path, *inner, "bias")
    return out


def flax_trees(net: nn.Module, tensors: Mapping[str, torch.Tensor]) -> dict[str, dict]:
    """{collection: flax tree} of float32 numpy arrays from `tensors`, keyed
    by `net`'s state-dict names (its state dict, or a subset such as an Adam
    moment of its parameters). 4-D tensors go back to HWIO (the transposed
    convs' TF layout is the same permutation)."""
    paths = flax_paths(net)
    trees: dict = {}
    for name, t in tensors.items():
        a = t.detach().float().cpu().numpy()
        if a.ndim == 4:
            a = np.transpose(a, (2, 3, 1, 0))
        _set(trees, paths[name], np.ascontiguousarray(a))
    return trees


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


def random_recover_params(recover: RecoverNet, seed: int = 0) -> dict:
    """Seeded random recover params in the flax layout, shaped after the
    given port module: glorot-uniform kernels, small random biases."""
    rs = np.random.RandomState(seed)
    tensors = {}
    for name, t in recover.state_dict().items():
        if t.dim() == 4:
            o, i, kh, kw = t.shape
            limit = np.sqrt(6.0 / (kh * kw * (i + o)))
            tensors[name] = torch.from_numpy(
                rs.uniform(-limit, limit, (o, i, kh, kw)).astype(np.float32))
        else:
            tensors[name] = torch.from_numpy((0.01 * rs.randn(*t.shape)).astype(np.float32))
    return flax_trees(recover, tensors)["params"]
