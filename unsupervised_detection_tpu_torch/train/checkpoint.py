"""Checkpoints of the port: one `.npz` file, numpy only.

A file holds flax parameter trees of the JAX package, flattened to keys
`<tree>/<scope>/.../<leaf>`, and, where it holds PWC weights, their search
range as `pwc_search_range`. numpy reads it on a host without JAX or orbax.

* An evaluation checkpoint holds `gen_params`, `gen_stats` and `pwc_params`
  (`save_eval_checkpoint`; tools/export_torch_checkpoint.py writes one from
  a JAX checkpoint).
* A training save (`save_checkpoint`: `model.best`, `model-<epoch>`) adds
  `rec_params`, both Adam states (`gen_opt/count`, `gen_opt/m/...`,
  `gen_opt/v/...`, and `rec_opt/...` alike), `step` and `rng`, the state of
  the port's torch.Generator. It is a superset of the evaluation file, so
  `test_generator` reads a trained `model.best` as it is. An exported JAX
  train state has no `rng` (JAX's key has no torch counterpart).
* A save of the recipe's game (recipe/game.py) adds its loop's counters
  and generators (`GAME_ENTRIES`); its `model.best` holds the evaluation
  trees, its `model-<cycle>` no PWC weights (PWC is frozen there).
* A scope save holds one tree (`pwc_params` or `rec_params`): what
  `--flow_ckpt` and `--recover_ckpt` name.

Where the JAX package reads the reference's TF1 checkpoints (an evaluation
checkpoint, `--flow_ckpt`, `--recover_ckpt`), the loaders here read a TF1
bundle's prefix too, through train/tf1_import.py.

Loading goes through convert.py's maps, the functions the parity tests
hold; the training side keeps the JAX package's three-scope semantics
(train/checkpoint.py:28-114 there): full saves with pruning to the
reference's 40, restores of one scope from either a full or a scope save.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from ..convert import (flax_trees, from_jax_params, from_jax_train_state, pwc_state_dict,
                       recover_state_dict)
from .optim import AdamState
from .tf1_bundle import read_bundle
from .tf1_import import is_tf_checkpoint, load_tf1_eval, tf1_state_dict

TREES = ("gen_params", "gen_stats", "pwc_params")
TRAIN_ENTRIES = ("rec_params", "gen_opt", "rec_opt", "step", "rng")
# a save of the recipe's game (recipe/game.py) adds its loop's state
GAME_ENTRIES = ("cycle", "best", "lr_scale", "data_rng", "mask_rng")
RANGE_KEY = "pwc_search_range"
BEST_NAME = "model.best"
MAX_TO_KEEP = 40  # reference saver: max_to_keep=40 (adversarial_learner.py:327)


def _flatten(tree: Mapping, prefix: str, out: dict) -> dict:
    for key, value in tree.items():
        if "/" in key:
            raise ValueError(f"scope name {key!r} holds a '/'")
        if isinstance(value, Mapping):
            _flatten(value, f"{prefix}/{key}", out)
        else:
            a = np.asarray(value)
            out[f"{prefix}/{key}"] = a.astype(np.float32) if a.dtype.kind == "f" else a
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


def save_trees(path: str, trees: Mapping) -> str:
    """Write `trees` ({name: nested dict of arrays, or one array}) to `path`
    as one `.npz`, through a temporary file renamed into place; with
    `pwc_params`, its search range is recorded. Returns the path."""
    arrays = {}
    if trees.get("pwc_params"):
        arrays[RANGE_KEY] = np.int32(pwc_search_range(trees["pwc_params"]))
    for name, tree in trees.items():
        if isinstance(tree, Mapping):
            _flatten(tree, name, arrays)
        else:
            arrays[name] = np.asarray(tree)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    return path


def load_trees(path: str) -> dict:
    """{name: nested dict of numpy arrays, or one array} from a checkpoint."""
    if not path or not os.path.isfile(path):
        raise IOError("Checkpoint file not found")
    out: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            name, *scopes = key.split("/")
            if not scopes:
                out[name] = data[key]
                continue
            node = out.setdefault(name, {})
            for scope in scopes[:-1]:
                node = node.setdefault(scope, {})
            node[scopes[-1]] = data[key]
    return out


def save_eval_checkpoint(path: str, gen_params: Mapping, gen_stats: Mapping,
                         pwc_params: Mapping) -> str:
    """Write the three flax trees (nested dicts of arrays) and the PWC
    search range to `path` (an `.npz`); returns the path."""
    return save_trees(path, dict(zip(TREES, (gen_params, gen_stats, pwc_params))))


def load_eval_trees(path: str):
    """(gen_params, gen_stats, pwc_params, search_range) from an evaluation
    checkpoint or a training save; the trees are nested dicts of float32
    numpy arrays."""
    trees = load_trees(path)
    if RANGE_KEY not in trees:
        raise ValueError(f"{path}: not an evaluation checkpoint (no {RANGE_KEY})")
    unexpected = set(trees) - set(TREES + TRAIN_ENTRIES + GAME_ENTRIES + (RANGE_KEY,))
    if unexpected:
        raise ValueError(f"{path}: unexpected entries {sorted(unexpected)}")
    return (trees["gen_params"], trees["gen_stats"], trees["pwc_params"],
            int(trees[RANGE_KEY]))


def load_eval_checkpoint(path: str, search_range: int):
    """(gen_state_dict, pwc_state_dict) for the port's models from an
    evaluation checkpoint, a training save or a TF1 bundle's prefix. Raises
    when the checkpoint's PWC search range is not `search_range` (the models
    are built for one range)."""
    if is_tf_checkpoint(path):
        return load_tf1_eval(path, search_range)
    gen_params, gen_stats, pwc_params, file_range = load_eval_trees(path)
    _check_range(path, file_range, search_range)
    return from_jax_params(gen_params, gen_stats, pwc_params)


def _check_range(path: str, file_range: int, search_range: int) -> None:
    if file_range != search_range:
        raise ValueError(
            f"checkpoint {path} holds PWC weights for search range {file_range}, "
            f"but --pwc_search_range={search_range}")


# --- training saves -----------------------------------------------------------
def train_trees(state) -> dict:
    """The flax-layout trees of a port `TrainState` (train/learner.py)."""
    gen = flax_trees(state.generator, state.generator.state_dict())
    trees = {"gen_params": gen["params"], "gen_stats": gen["batch_stats"],
             "rec_params": flax_trees(state.recover, state.recover.state_dict())["params"],
             "pwc_params": flax_trees(state.pwc, state.pwc.state_dict())["params"],
             "step": np.int32(state.step), "rng": state.rng.get_state().numpy()}
    for name, opt, net in (("gen_opt", state.gen_opt, state.generator),
                           ("rec_opt", state.rec_opt, state.recover)):
        trees[name] = {"count": np.int32(opt.count),
                       "m": flax_trees(net, opt.m)["params"],
                       "v": flax_trees(net, opt.v)["params"]}
    return trees


def save_checkpoint(checkpoint_dir: str, name: str, state) -> str:
    """Save the full train state as `<checkpoint_dir>/<name>`."""
    return save_trees(os.path.abspath(os.path.join(checkpoint_dir, name)), train_trees(state))


def save_epoch(checkpoint_dir: str, epoch: int, state) -> str:
    path = save_checkpoint(checkpoint_dir, f"model-{epoch}", state)
    _prune_old(checkpoint_dir)
    return path


def _epoch_saves(checkpoint_dir: str) -> list[tuple[int, str]]:
    """Sorted (epoch, name) of the `model-<epoch>` saves in the directory."""
    saves = []
    for entry in os.listdir(checkpoint_dir):
        if entry.startswith("model-"):
            try:
                saves.append((int(entry[len("model-"):]), entry))
            except ValueError:
                continue
    return sorted(saves)


def _prune_old(checkpoint_dir: str, keep: int = MAX_TO_KEEP) -> None:
    """Drop the oldest model-<epoch> saves beyond `keep` (model.best and the
    scope saves are never pruned)."""
    saves = _epoch_saves(checkpoint_dir)
    for _, entry in saves[:-keep] if len(saves) > keep else []:
        os.remove(os.path.join(checkpoint_dir, entry))


def save_best(checkpoint_dir: str, state) -> str:
    return save_checkpoint(checkpoint_dir, BEST_NAME, state)


def _device_dict(tensors: Mapping[str, torch.Tensor], like: torch.nn.Module) -> dict:
    device = next(like.parameters()).device
    return {k: v.to(device) for k, v in tensors.items()}


def load_train_state(state, fields: Mapping):
    """Load the fields of a JAX-layout train state (nested dicts of arrays,
    as `load_trees` or the JAX package's `TrainState` give them) into the
    port's `state` in place; returns it. The nets load strictly; without
    PWC weights (a game-arm save) the PWC net is kept. Without `rng` (a
    JAX state) `state.rng` is kept: JAX's key has no torch counterpart."""
    ported = from_jax_train_state(fields)
    state.generator.load_state_dict(ported["gen"])
    state.recover.load_state_dict(ported["rec"])
    if ported["pwc"]:
        state.pwc.load_state_dict(ported["pwc"])
    for name, net in (("gen_opt", state.generator), ("rec_opt", state.recover)):
        opt = ported[name]
        setattr(state, name, AdamState(count=opt["count"], m=_device_dict(opt["m"], net),
                                       v=_device_dict(opt["v"], net)))
    state.step = ported["step"]
    if "rng" in fields:
        state.rng.set_state(torch.from_numpy(np.asarray(fields["rng"], dtype=np.uint8)))
    return state


def restore_checkpoint(path: str, state):
    """Load a full training save (the port's, or an exported JAX train
    state) into `state` in place; returns it."""
    trees = load_trees(path)
    if RANGE_KEY in trees:
        _check_range(path, int(trees[RANGE_KEY]), state.pwc.search_range)
    return load_train_state(state, trees)


def restore_params_scope(path: str, net: torch.nn.Module, attr: str) -> None:
    """Load one net's parameters, `attr` ("pwc_params" or "rec_params"),
    from a full save, a scope save or a TF1 bundle's prefix into `net` in
    place."""
    if is_tf_checkpoint(path):
        net.load_state_dict(tf1_state_dict(read_bundle(path), net, path))
        return
    to_state_dict = {"pwc_params": pwc_state_dict, "rec_params": recover_state_dict}[attr]
    trees = load_trees(path)
    if not trees.get(attr):
        raise ValueError(f"{path}: holds no {attr}")
    if attr == "pwc_params":
        _check_range(path, pwc_search_range(trees[attr]), net.search_range)
    net.load_state_dict(to_state_dict(trees[attr]))


def save_scope(checkpoint_dir: str, name: str, net: torch.nn.Module, attr: str) -> str:
    """Write `net`'s parameters as the scope save `<checkpoint_dir>/<name>`,
    one tree `attr` ("pwc_params" or "rec_params"): what the pretraining
    stages write and `--flow_ckpt` / `--recover_ckpt` read. A PWC save
    records its search range."""
    trees = {attr: flax_trees(net, net.state_dict())["params"]}
    return save_trees(os.path.abspath(os.path.join(checkpoint_dir, name)), trees)


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The `model-<epoch>` save of the highest epoch (reference resume
    logic, adversarial_learner.py:345-353), or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    saves = _epoch_saves(checkpoint_dir)
    return os.path.join(checkpoint_dir, saves[-1][1]) if saves else None


def checkpoint_exists(path: str) -> bool:
    return bool(path) and os.path.isfile(path)
