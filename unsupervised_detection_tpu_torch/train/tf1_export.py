"""Write the port's weights as a TF1 checkpoint of the reference: counterpart
of unsupervised_detection_tpu/train/tf1_export.py, without TensorFlow.

The three nets go to their flax trees (`convert.flax_trees`), the trees'
leaves to the reference's names (train/tf1_import.py, the MaskNet// and
FlownetS// double slash included), and the tensors into one bundle
(train/tf1_bundle.py): every variable the reference's test-time saver
restores, plus `global_step`, which its train-time resume reads
(adversarial_learner.py:326). A model the port trains then goes to the
reference's own test_generator.py / test_generator_ensemble.py, and to the
JAX package's `restore_tf1_full`.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from ..convert import _leaves, flax_trees
from .tf1_bundle import write_bundle
from .tf1_import import NAMERS


def tf1_tensors(net: nn.Module) -> dict[str, np.ndarray]:
    """{TF1 name: float32 array} of a port network's parameters and
    buffers."""
    namer = NAMERS[type(net)]
    out = {}
    for tree in flax_trees(net, net.state_dict()).values():
        for path, value in _leaves(tree):
            out[namer(path)] = value
    return out


def export_tf1_checkpoint(state, path: str, global_step: int | None = None) -> str:
    """Write the generator, recover net and PWC of `state` (a `TrainState`,
    or any object with those nets and a `step`) as a TF1 bundle at the
    prefix `path`, with an int64 `global_step` (the state's step by
    default); returns the prefix."""
    tensors: dict[str, np.ndarray] = {}
    for net in (state.generator, state.recover, state.pwc):
        tensors.update(tf1_tensors(net))
    tensors["global_step"] = np.int64(state.step if global_step is None else global_step)
    return write_bundle(path, tensors)
