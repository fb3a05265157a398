"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points (the train and pretraining CLIs among them)
default to the card and raise without one, and its kernel wrappers take the
plain version only for CPU tensors."""

import dataclasses
import importlib
import os
import re
import subprocess
import sys

import pytest
import torch

from unsupervised_detection_tpu.config import Config as JaxConfig
from unsupervised_detection_tpu_torch import Config, parse_flags, pretrain_flow
from unsupervised_detection_tpu_torch import pretrain_recover as pretrain_recover_cli
from unsupervised_detection_tpu_torch.benchlib import build_forward
from unsupervised_detection_tpu_torch.eval import Evaluator
from unsupervised_detection_tpu_torch.ops.cost_volume import cost_volume
from unsupervised_detection_tpu_torch.ops.warp import dense_image_warp
from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner
from unsupervised_detection_tpu_torch.train.objective import AdversarialObjective
from unsupervised_detection_tpu_torch.train.pretrain import pretrain_recover
from unsupervised_detection_tpu_torch.train.pretrain_pwc import pretrain_pwc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "unsupervised_detection_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "unsupervised_detection_tpu")
TPU_ONLY = ("use_pallas", "warp_method", "mesh_data", "mesh_model")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_imports_with_jax_blocked():
    # every module of the port, and chip_smoke, import in a fresh process in
    # which importing JAX, flax, orbax or the JAX package raises
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import unsupervised_detection_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
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
        r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|unsupervised_detection_tpu)(\.|\s|$)", re.M)
    offenders = [p for p in _port_sources() if pattern.search(open(p).read())]
    assert not offenders, offenders


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device exists")
    cfg = Config(batch_size=1, reader_height=64, reader_width=64, img_height=32, img_width=32)
    for entry in (Evaluator, build_forward, AdversarialObjective, AdversarialLearner):
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


def test_wrappers_take_plain_version_only_on_cpu():
    a = torch.randn(1, 4, 6, 8)
    flow = torch.randn(1, 4, 6, 2)
    counts = (cost_volume.launches, dense_image_warp.launches)
    assert cost_volume(a, a, 2).shape == (1, 4, 6, 25)
    assert dense_image_warp(a, flow).shape == a.shape
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
