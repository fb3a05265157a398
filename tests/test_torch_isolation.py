"""The PyTorch port stands alone: it imports neither JAX, the JAX package
nor TensorFlow, its entry points (the train and pretraining CLIs and the
recipe's and the game's instruments among them) default to the card and raise without one, and its
kernel wrappers take the plain version only for CPU tensors."""

import dataclasses
import importlib
import os
import re
import subprocess
import sys

import pytest
import torch

from unsupervised_detection_tpu.config import Config as JaxConfig
from unsupervised_detection_tpu_torch import Config, e2e_jmean, parse_flags, pretrain_flow
from unsupervised_detection_tpu_torch import post_processing
from unsupervised_detection_tpu_torch import pretrain_recover as pretrain_recover_cli
from unsupervised_detection_tpu_torch import test_generator_ensemble
from unsupervised_detection_tpu_torch.benchlib import build_forward
from unsupervised_detection_tpu_torch.eval import EnsembleEvaluator, Evaluator
from unsupervised_detection_tpu_torch.postproc.propagate import pwc_flow_fn, scan_propagate
from unsupervised_detection_tpu_torch.recipe import flow_diag as recipe_flow_diag
from unsupervised_detection_tpu_torch.recipe import game as recipe_game
from unsupervised_detection_tpu_torch.recipe import game_stats as recipe_game_stats
from unsupervised_detection_tpu_torch.recipe import inspect_mask as recipe_inspect_mask
from unsupervised_detection_tpu_torch.recipe import pretrain_pwc as recipe_pretrain_pwc
from unsupervised_detection_tpu_torch.recipe import scenes as recipe_scenes
from unsupervised_detection_tpu_torch.recipe import synth as recipe_synth
from unsupervised_detection_tpu_torch.ops.cost_volume import cost_volume
from unsupervised_detection_tpu_torch.ops.warp import dense_image_warp
from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner
from unsupervised_detection_tpu_torch.train.objective import AdversarialObjective
from unsupervised_detection_tpu_torch.train.pretrain import pretrain_recover
from unsupervised_detection_tpu_torch.train.pretrain_pwc import pretrain_pwc
from unsupervised_detection_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "unsupervised_detection_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "unsupervised_detection_tpu", "tensorflow")
TPU_ONLY = ("use_pallas", "warp_method")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_imports_with_jax_blocked():
    # every module of the port, and chip_smoke, import in a fresh process in
    # which importing JAX, flax, orbax, the JAX package or TensorFlow raises;
    # scan_propagate and the profiling helpers run there
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import unsupervised_detection_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from unsupervised_detection_tpu_torch.postproc.propagate import scan_propagate
from unsupervised_detection_tpu_torch.utils.profiling import StepTimer, sync, trace
import torch
sync(scan_propagate(torch.rand(3, 4, 5), torch.zeros(2, 4, 5, 2)))
leaked = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
assert not leaked, leaked
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 40


def test_source_scan_finds_no_jax_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|unsupervised_detection_tpu|tensorflow)"
        r"(\.|\s|$)", re.M)
    offenders = [p for p in _port_sources() if pattern.search(open(p).read())]
    assert not offenders, offenders


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device exists")
    cfg = Config(batch_size=1, reader_height=64, reader_width=64, img_height=32, img_width=32)
    for entry in (Evaluator, EnsembleEvaluator, build_forward, AdversarialObjective,
                  AdversarialLearner):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(cfg)
    train_cli = importlib.import_module("unsupervised_detection_tpu_torch.train.__main__")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--allow_random_flow", "--batch_size=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_pwc(cfg, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_recover(cfg.replace(allow_random_flow=True), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_flow.main(["--pretrain_steps=1", "--batch_size=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_recover_cli.main(["--allow_random_flow", "--pretrain_steps=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_generator_ensemble.main(["--batch_size=1"])
    # the end-to-end chain, before it renders anything
    out_root = tmp_path / "jmean"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e_jmean.main([str(out_root)])
    assert not out_root.exists()
    # the PWC backend, alone and through the post-processing CLI, before it
    # reads its checkpoint
    missing = str(tmp_path / "pwc.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pwc_flow_fn(missing)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        post_processing.main(["--flow_backend=pwc", f"--flow_ckpt={missing}",
                              f"--path_buffer={tmp_path}"])
    # the recipe: the game, the diagnostic and the PWC recipe before they
    # make a directory or read a checkpoint, the game's nets and the scenes'
    # render
    state_dir, pwc_dir = tmp_path / "game", tmp_path / "pwc"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe_game.main(["1", "1", "1", "0.25", "64", "128", missing, str(state_dir)],
                         environ={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe_game.Game(recipe_game.GameArgs(height=64, width=128))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe_flow_diag.main([missing])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe_pretrain_pwc.main(["1", "1", "64", "64", str(pwc_dir)], environ={})
    assert not state_dir.exists() and not pwc_dir.exists()
    draws = recipe_scenes.game_draws(torch.Generator().manual_seed(0), 1, 64, 64, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe_scenes.render_game(draws, 64, 64, 16)
    # the game's instruments: the synthetic game and the mask inspector
    # before they build a net or read a checkpoint; the log summary touches
    # no tensor and takes no device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe_synth.main(["1", "1", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe_synth.make_game(recipe_synth.SynthArgs(1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe_inspect_mask.main([missing, missing, "64", "128", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe_inspect_mask.inspect(missing, missing, 64, 128, 1)
    assert not hasattr(recipe_game_stats, "resolve_device")


def test_wrappers_take_plain_version_only_on_cpu():
    a = torch.randn(1, 4, 6, 8)
    flow = torch.randn(1, 4, 6, 2)
    counts = (cost_volume.launches, dense_image_warp.launches)
    assert cost_volume(a, a, 2).shape == (1, 4, 6, 25)
    assert dense_image_warp(a, flow).shape == a.shape
    # the device propagation and the completion helper on CPU tensors: the
    # plain warp, no launch counted
    avg = scan_propagate(torch.rand(3, 4, 6), torch.zeros(2, 4, 6, 2))
    profiling.sync(avg)
    assert avg.shape == (3, 4, 6)
    assert (cost_volume.launches, dense_image_warp.launches) == counts
    # a tensor on neither the CPU nor a CUDA device is refused, not sent to
    # the plain version
    meta = torch.empty(1, 4, 6, 8, device="meta")
    with pytest.raises(ValueError):
        cost_volume(meta, meta, 2)
    with pytest.raises(ValueError):
        dense_image_warp(meta, torch.empty(1, 4, 6, 2, device="meta"))


def test_config_keeps_jax_flags_without_tpu_knobs():
    # every field of the port is a JAX flag with the same default; the
    # TPU-only knobs are not fields and are refused as flags
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(Config)}
    assert set(port_fields) <= set(jax_fields) - set(TPU_ONLY)
    assert all(port_fields[k] == jax_fields[k] for k in port_fields)
    cfg = parse_flags(["--batch_size=8", "--compute_dtype", "bfloat16", "--test_crop=0.5"])
    assert (cfg.batch_size, cfg.compute_dtype, cfg.test_crop) == (8, "bfloat16", 0.5)
    for name in TPU_ONLY:
        with pytest.raises(SystemExit):
            parse_flags([f"--{name}=1"])
