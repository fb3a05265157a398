"""Evaluation checkpoints of the port: one `.npz` file, numpy only.

The file holds the flax parameter trees of the JAX package, flattened to
keys `gen_params/<scope>/.../<leaf>`, `gen_stats/...` and `pwc_params/...`,
and the PWC search range as `pwc_search_range`. numpy reads it on a host
without JAX or orbax; `tools/export_torch_checkpoint.py` writes it from a
JAX checkpoint with `save_eval_checkpoint`. Loading carries the trees into
the port's state dicts through `convert.from_jax_params`, the function the
parity tests hold.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np

from ..convert import from_jax_params

TREES = ("gen_params", "gen_stats", "pwc_params")
RANGE_KEY = "pwc_search_range"


def _flatten(tree: Mapping, prefix: str, out: dict) -> dict:
    for key, value in tree.items():
        if "/" in key:
            raise ValueError(f"scope name {key!r} holds a '/'")
        if isinstance(value, Mapping):
            _flatten(value, f"{prefix}/{key}", out)
        else:
            out[f"{prefix}/{key}"] = np.asarray(value, dtype=np.float32)
    return out


def pwc_search_range(pwc_params: Mapping) -> int:
    """The search range the PWC weights were trained with: the top level's
    estimator takes the (2r+1)^2 costs alone as its input."""
    top = max(int(k[len("estimator"):]) for k in pwc_params if k.startswith("estimator"))
    n_off = np.shape(pwc_params[f"estimator{top}"][f"conv{top}_0"]["Conv_0"]["kernel"])[2]
    r = (int(round(np.sqrt(n_off))) - 1) // 2
    if (2 * r + 1) ** 2 != n_off:
        raise ValueError(f"top estimator takes {n_off} channels, not (2r+1)^2")
    return r


def save_eval_checkpoint(path: str, gen_params: Mapping, gen_stats: Mapping,
                         pwc_params: Mapping) -> str:
    """Write the three flax trees (nested dicts of arrays) and the PWC
    search range to `path` (an `.npz`); returns the path."""
    arrays = {RANGE_KEY: np.int32(pwc_search_range(pwc_params))}
    for name, tree in zip(TREES, (gen_params, gen_stats, pwc_params)):
        _flatten(tree, name, arrays)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)
    return path


def load_eval_trees(path: str):
    """(gen_params, gen_stats, pwc_params, search_range) from an evaluation
    checkpoint; the trees are nested dicts of float32 numpy arrays."""
    if not path or not os.path.isfile(path):
        raise IOError("Checkpoint file not found")
    trees = {name: {} for name in TREES}
    with np.load(path, allow_pickle=False) as data:
        if RANGE_KEY not in data.files:
            raise ValueError(f"{path}: not an evaluation checkpoint (no {RANGE_KEY})")
        search_range = int(data[RANGE_KEY])
        for key in data.files:
            if key == RANGE_KEY:
                continue
            name, *scopes, leaf = key.split("/")
            if name not in trees:
                raise ValueError(f"{path}: unexpected entry {key!r}")
            node = trees[name]
            for scope in scopes:
                node = node.setdefault(scope, {})
            node[leaf] = data[key]
    return trees["gen_params"], trees["gen_stats"], trees["pwc_params"], search_range


def load_eval_checkpoint(path: str, search_range: int):
    """(gen_state_dict, pwc_state_dict) for the port's models from an
    evaluation checkpoint. Raises when the file's PWC search range is not
    `search_range` (the models are built for one range)."""
    gen_params, gen_stats, pwc_params, file_range = load_eval_trees(path)
    if file_range != search_range:
        raise ValueError(
            f"checkpoint {path} holds PWC weights for search range {file_range}, "
            f"but --pwc_search_range={search_range}")
    return from_jax_params(gen_params, gen_stats, pwc_params)
