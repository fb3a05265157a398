"""The port's evaluation checkpoint (`train/checkpoint.py`, an `.npz` read
with numpy alone) and its exporter `tools/export_torch_checkpoint.py`: the
committed checkpoints exported in both of the JAX package's layouts give
exactly the state dicts that `convert.from_jax_params` makes from them."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_parity import (GAME_CKPT, PWC_CKPT, PWC_CKPT_SEARCH_RANGE,
                         REPO, committed_checkpoints, torch_threads)
from unsupervised_detection_tpu.train import checkpoint as jax_ckpt
from unsupervised_detection_tpu_torch.convert import from_jax_params, random_jax_params
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet
from unsupervised_detection_tpu_torch.train import checkpoint

_threads = torch_threads(2)


def _exporter():
    path = os.path.join(REPO, "tools", "export_torch_checkpoint.py")
    spec = importlib.util.spec_from_file_location("export_torch_checkpoint", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_state_dicts_equal(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == torch.float32, k
            assert torch.equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def committed():
    trees = committed_checkpoints()
    return trees, from_jax_params(*trees)


def test_export_game_arm_and_pwc_saves(committed, tmp_path):
    out = str(tmp_path / "flagship.npz")
    assert _exporter().main([out, GAME_CKPT, PWC_CKPT]) == 0
    got = checkpoint.load_eval_checkpoint(out, PWC_CKPT_SEARCH_RANGE)
    _assert_state_dicts_equal(got, committed[1])
    # the models load it
    GeneratorNet().load_state_dict(got[0])
    PWCNet(search_range=PWC_CKPT_SEARCH_RANGE).load_state_dict(got[1])


def test_export_full_train_state(committed, tmp_path):
    # a full-state save (train.py's layout: TrainState fields at the top,
    # pwc_params filled) exports without a separate PWC save
    gen_p, gen_s, pwc_p = committed[0]
    full = {"step": np.int32(3), "gen_params": gen_p, "gen_stats": gen_s, "pwc_params": pwc_p}
    path = jax_ckpt.save_checkpoint(str(tmp_path), "model.best", full)
    out = str(tmp_path / "full.npz")
    _exporter().export(out, path)
    _assert_state_dicts_equal(checkpoint.load_eval_checkpoint(out, 2), committed[1])


def test_export_refuses_game_arm_without_pwc(tmp_path):
    with pytest.raises(SystemExit, match="no PWC weights"):
        _exporter().export(str(tmp_path / "x.npz"), GAME_CKPT)
    with pytest.raises(OSError, match="Checkpoint file not found"):
        _exporter().export(str(tmp_path / "x.npz"), str(tmp_path / "missing"))


@pytest.mark.parametrize("search_range", [2, 4])
def test_npz_round_trip_is_exact(search_range, tmp_path):
    trees = random_jax_params(GeneratorNet(), PWCNet(search_range=search_range), seed=3)
    path = checkpoint.save_eval_checkpoint(str(tmp_path / "r.npz"), *trees)
    *loaded, file_range = checkpoint.load_eval_trees(path)
    assert file_range == search_range == checkpoint.pwc_search_range(trees[2])
    _assert_state_dicts_equal(from_jax_params(*loaded), from_jax_params(*trees))
    _assert_state_dicts_equal(checkpoint.load_eval_checkpoint(path, search_range),
                              from_jax_params(*trees))
    # plain numpy reads it: no pickled objects
    with np.load(path, allow_pickle=False) as f:
        assert int(f["pwc_search_range"]) == search_range


def test_load_refuses_wrong_range_and_missing_file(tmp_path):
    trees = random_jax_params(GeneratorNet(), PWCNet(search_range=2), seed=0)
    path = checkpoint.save_eval_checkpoint(str(tmp_path / "r2.npz"), *trees)
    with pytest.raises(ValueError, match="search range 2.*--pwc_search_range=4"):
        checkpoint.load_eval_checkpoint(path, 4)
    for missing in ("", str(tmp_path / "nothing.npz")):
        with pytest.raises(OSError, match="Checkpoint file not found"):
            checkpoint.load_eval_checkpoint(missing, 2)
    not_ckpt = str(tmp_path / "other.npz")
    np.savez(not_ckpt, a=np.zeros(3))
    with pytest.raises(ValueError, match="not an evaluation checkpoint"):
        checkpoint.load_eval_checkpoint(not_ckpt, 2)
