"""The port's tile copy at a device-held offset (plain PyTorch version, which
the CUDA kernel is held against on the card) against the Mosaic repro it
replaces, tools/repro_mosaic_dynamic_dma.py: the numpy slice the repro takes
as `want`, and the repro's Pallas kernel run through the Pallas interpreter,
on the CPU. A copy has no rounding: every comparison is exact."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from unsupervised_detection_tpu_torch.ops.dynamic_copy import (
    STEPS, TILE, dynamic_copy, dynamic_copy_plain, repro)

REPRO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools", "repro_mosaic_dynamic_dma.py")
SHAPES = {0: (1024, 256), 1: (128, 1024)}   # the repro's buffers per axis


def _repro_module():
    spec = importlib.util.spec_from_file_location("repro_mosaic_dynamic_dma", REPRO)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _src(axis, seed=0):
    return np.random.RandomState(seed).rand(*SHAPES[axis]).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1])
def test_plain_matches_repro_slice(axis):
    # the repro's `want` (tools/repro_mosaic_dynamic_dma.py:75-76) at offset 2
    src = _src(axis)
    start = 2 * (8 if axis == 0 else 256)
    want = np.asarray(src[start:start + 128, :] if axis == 0 else src[:, start:start + 256])
    got = dynamic_copy_plain(torch.tensor([2], dtype=torch.int32), torch.from_numpy(src), axis)
    assert got.shape == TILE
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
def test_plain_matches_repro_kernel_interpreted(axis, monkeypatch):
    # the repro's own pallas_call, run by the Pallas interpreter (it passes
    # no `interpret` flag, so the flag is added around its call)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    run, shape = _repro_module().build(axis)
    src = _src(axis, seed=axis + 1)
    assert shape == SHAPES[axis]
    want = np.asarray(run(jnp.asarray([2], jnp.int32), jnp.asarray(src)))
    got = dynamic_copy(torch.tensor([2], dtype=torch.int32), torch.from_numpy(src), axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("offset", [-3, 0, 5, 1000])
def test_plain_clamps_like_dynamic_slice(axis, offset):
    src = _src(axis, seed=7)
    starts = [0, 0]
    starts[axis] = offset * STEPS[axis]
    want = np.asarray(jax.lax.dynamic_slice(jnp.asarray(src), starts, TILE))
    got = dynamic_copy_plain(torch.tensor([offset], dtype=torch.int32), torch.from_numpy(src),
                             axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_repro_entry_on_cpu_uses_plain_version():
    before = dynamic_copy.launches
    assert repro(device="cpu") == {"lane": True, "sublane": True}
    assert dynamic_copy.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    src = torch.zeros(SHAPES[1], device="meta")
    with pytest.raises(ValueError):
        dynamic_copy(torch.zeros(1, dtype=torch.int32, device="meta"), src, 1)
    with pytest.raises(ValueError):
        dynamic_copy(torch.zeros(1, dtype=torch.int32), torch.zeros(SHAPES[1]), 2)
