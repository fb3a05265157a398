"""The reference's TF1 checkpoints, read without TensorFlow: counterpart of
unsupervised_detection_tpu/train/tf1_import.py.

The published checkpoints are TF1 bundles (train/tf1_bundle.py reads them)
with three scopes (adversarial_learner.py:326-331 of the reference):

* `MaskNet//...`: the generator's convs and its positionally named
  `batch_normalization[_k]` variables (tf.layers numbers the BNs of a scope
  in creation order; the upsample blocks open a scope of their own, so
  their counters restart);
* `FlownetS//...`: the recover net's convs, `weights` / `biases`;
* `pwcnet/...`: the feature pyramid (`featpyr`), the estimators
  (`predict_flow/conv{l}_{i}`), the context nets (`ctxt`) and the
  transposed-conv upsamplers (`upsample/up_flow{l}`, `up_feat{l}`).

The name maps take the flax paths of `convert.flax_paths` (the collection
dropped) to these names. A bundle is read into the flax trees that
`convert.state_dict_from_trees` turns into the port's state dicts: TF conv
kernels are HWIO and conv2d_transpose kernels [h, w, out, in], the layouts
of the flax trees, so convert.py's transposes do the rest.

A bundle carries no search range: it is read off the top estimator's first
kernel, whose input channels are the (2r+1)^2 costs.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..convert import _set, _skeleton, flax_paths, state_dict_from_trees
from ..models import GeneratorNet, PWCNet, RecoverNet
from .tf1_bundle import read_bundle

# The reference enters its MaskNet / FlownetS variable scopes through a
# name-scope string that ends in "/", and TF1 adds another: every variable
# of the published checkpoints is named "MaskNet//..." / "FlownetS//...".
GEN_PREFIX = "MaskNet//"
REC_PREFIX = "FlownetS//"

# Creation order of the generator's top-level BN variables (nets.py:4-42 of
# the reference); the upsample blocks' BNs are not in it.
_GEN_TOPLEVEL_BN_ORDER = [
    "conv1", "conv2_downsample", "conv3", "conv4_downsample", "conv5",
    "conv6", "conv7_atrous", "conv8_atrous", "conv9_atrous", "conv10_atrous",
    "conv11", "conv12", "conv14", "conv16", "conv17",
]
_BN_PARAM = {"bn_gamma": "gamma", "bn_beta": "beta",
             "bn_moving_mean": "moving_mean", "bn_moving_variance": "moving_variance"}
# scope -> (attribute of a train state, the prefix that shows it in a bundle)
SCOPES = {"pwc": ("pwc", "pwcnet/"), "recover": ("recover", "FlownetS/"),
          "gen": ("generator", "MaskNet/")}


def _gen_bn_scope(layer: str) -> str:
    if layer.endswith("_upsample"):
        return f"{GEN_PREFIX}{layer}/batch_normalization"
    i = _GEN_TOPLEVEL_BN_ORDER.index(layer)
    suffix = "" if i == 0 else f"_{i}"
    return f"{GEN_PREFIX}batch_normalization{suffix}"


def generator_name(path: tuple[str, ...]) -> str:
    """TF1 name of the generator's flax leaf at `path` (its convs sit at
    (layer, "conv", leaf), an upsample block's at (layer, "conv", "conv",
    leaf); its BN leaves at (layer, [ "conv",] bn_*))."""
    layer, leaf = path[0], path[-1]
    if leaf in _BN_PARAM:
        return f"{_gen_bn_scope(layer)}/{_BN_PARAM[leaf]}"
    conv = f"{layer}/{layer}_conv" if layer.endswith("_upsample") else layer
    return f"{GEN_PREFIX}{conv}/{leaf}"


def recover_name(path: tuple[str, ...]) -> str:
    """TF1 name of the recover net's flax leaf at `path`."""
    return f"{REC_PREFIX}{path[0]}/{'weights' if path[-1] == 'kernel' else 'biases'}"


def pwc_name(path: tuple[str, ...]) -> str:
    """TF1 name of PWC's flax leaf at `path`."""
    top, leaf = path[0], path[-1]
    if top == "featpyr":
        return f"pwcnet/featpyr/{path[1]}/{leaf}"
    if top.startswith("estimator"):
        return f"pwcnet/predict_flow/{path[1]}/{leaf}"
    if top.startswith("ctxt"):
        return f"pwcnet/ctxt/{path[1]}/{leaf}"
    if top.startswith(("up_flow", "up_feat")):
        return f"pwcnet/upsample/{top}/{leaf}"
    raise KeyError(f"unmapped PWC param path {path}")


NAMERS = {GeneratorNet: generator_name, RecoverNet: recover_name, PWCNet: pwc_name}


def name_map(net: nn.Module) -> dict[tuple[str, ...], str]:
    """flax path (without its collection) -> TF1 name, for every parameter
    and buffer of a port network."""
    namer = NAMERS[type(net)]
    return {tuple(path): namer(tuple(path)) for _, *path in flax_paths(net).values()}


def is_tf_checkpoint(path: str) -> bool:
    return bool(path) and os.path.isfile(path + ".index")


def bundle_search_range(tensors: dict, top: int = 6) -> int | None:
    """The search range of a bundle's PWC weights, None without them."""
    kernel = tensors.get(f"pwcnet/predict_flow/conv{top}_0/kernel")
    if kernel is None:
        return None
    n_off = kernel.shape[2]
    r = (int(round(np.sqrt(n_off))) - 1) // 2
    if (2 * r + 1) ** 2 != n_off:
        raise ValueError(f"pwcnet/predict_flow/conv{top}_0/kernel takes {n_off} channels, "
                         "not (2r+1)^2")
    return r


def _flax_shape(shape) -> tuple[int, ...]:
    """The flax (TF) shape of a port tensor: OIHW -> HWIO (a transposed
    conv's (in, out, h, w) -> [h, w, out, in], the same permutation)."""
    shape = tuple(shape)
    return tuple(shape[i] for i in (2, 3, 1, 0)) if len(shape) == 4 else shape


def tf1_state_dict(tensors: dict, net: nn.Module, path: str = "") -> dict[str, torch.Tensor]:
    """`net`'s state dict from a bundle's tensors (`read_bundle`); `net`
    gives the names and shapes, and may live on the meta device. Raises
    ValueError, naming the variable, on a missing variable or a shape
    mismatch, and naming both ranges on a PWC search range other than the
    net's."""
    if isinstance(net, PWCNet):
        file_range = bundle_search_range(tensors, net.pyr_lvls)
        if file_range is not None and file_range != net.search_range:
            raise ValueError(
                f"checkpoint {path} holds PWC weights for search range {file_range}, "
                f"but --pwc_search_range={net.search_range}")
    trees: dict = {}
    shapes = {name: t.shape for name, t in net.state_dict().items()}
    namer = NAMERS[type(net)]
    for name, (collection, *fpath) in flax_paths(net).items():
        tf_name = namer(tuple(fpath))
        if tf_name not in tensors:
            raise ValueError(f"checkpoint {path} has no variable {tf_name!r} (for {name})")
        value, want = tensors[tf_name], _flax_shape(shapes[name])
        if tuple(value.shape) != want:
            raise ValueError(f"checkpoint {path}: variable {tf_name!r} has shape "
                             f"{tuple(value.shape)}, the port's {name} needs {want}")
        _set(trees.setdefault(collection, {}), fpath, np.asarray(value, np.float32))
    return state_dict_from_trees(net, trees)


def load_tf1_eval(path: str, search_range: int):
    """(gen_state_dict, pwc_state_dict) of a full bundle (the reference's
    PWC: 6 levels, flow at level 2), as `load_eval_checkpoint` gives them
    for an `.npz`."""
    tensors = read_bundle(path)
    pwc_sd = tf1_state_dict(tensors, _skeleton(PWCNet, search_range=search_range), path)
    return tf1_state_dict(tensors, _skeleton(GeneratorNet), path), pwc_sd


def restore_tf1_scope(path: str, state, scope: str):
    """Restore one scope ("pwc", "recover", "gen") or all three ("full") of
    a train state (train/learner.py's `TrainState`, or any object with the
    nets it names) from the bundle at `path`, in place; returns the state.
    As the JAX package, only the scopes the bundle holds are filled, extra
    variables (Adam slots, beta1_power) are ignored, and "full" also sets
    the step from `global_step`."""
    if scope not in SCOPES and scope != "full":
        raise ValueError(f"unknown scope {scope!r}")
    tensors = read_bundle(path)
    for s in SCOPES if scope == "full" else (scope,):
        attr, prefix = SCOPES[s]
        if any(n.startswith(prefix) for n in tensors):
            net = getattr(state, attr)
            net.load_state_dict(tf1_state_dict(tensors, net, path))
    if scope == "full" and "global_step" in tensors and hasattr(state, "step"):
        # the reference's full saver holds global_step (adversarial_learner.py:326)
        state.step = int(tensors["global_step"])
    return state


def restore_tf1_full(path: str, state):
    """Restore MaskNet, FlownetS and pwcnet from one bundle (the published
    trained models hold all three; test_generator.py:45-56 of the
    reference)."""
    return restore_tf1_scope(path, state, "full")
