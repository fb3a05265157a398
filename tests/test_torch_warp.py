"""The port's backward warp (plain PyTorch version, which the CUDA kernel is
held against on the card) against the JAX package's `_warp_quad` and its
Pallas window kernel run through the Pallas interpreter, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import clamp_flow
from unsupervised_detection_tpu.ops.pallas.warp_kernel import (
    warp_window_pallas, window_overflow_blocks)
from unsupervised_detection_tpu.ops.warp import _warp_quad
from unsupervised_detection_tpu_torch.ops.warp import dense_image_warp, warp_plain


@pytest.mark.parametrize("shape", [(2, 12, 20, 128), (2, 24, 40, 32), (1, 7, 9, 3)])
def test_plain_bit_equal_to_warp_quad_float32(shape):
    # the plain version repeats _warp_quad's float32 arithmetic op for op:
    # expected bit-equal, including every clamp
    rs = np.random.RandomState(sum(shape))
    b, h, w, c = shape
    image = rs.randn(b, h, w, c).astype(np.float32)
    flow = clamp_flow(rs, b, h, w)
    got = warp_plain(torch.from_numpy(image), torch.from_numpy(flow)).numpy()
    want = np.asarray(_warp_quad(jnp.asarray(image), jnp.asarray(flow)))
    np.testing.assert_array_equal(got, want)


def test_plain_matches_warp_quad_bfloat16():
    # bfloat16 image and flow; PyTorch rounds after every lerp operation, XLA
    # may keep float32 inside its fusion -> within a few bfloat16 ulps of the
    # largest value
    rs = np.random.RandomState(1)
    image = rs.randn(2, 12, 20, 64).astype(np.float32)
    flow = clamp_flow(rs, 2, 12, 20)
    got = warp_plain(torch.from_numpy(image).bfloat16(), torch.from_numpy(flow).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(_warp_quad(jnp.asarray(image, jnp.bfloat16),
                                 jnp.asarray(flow, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=4 * 2.0**-8 * np.abs(want).max())


def test_plain_matches_window_kernel_interpret():
    # the TPU window kernel on one in-window case at (1, 48, 80, 64), as
    # tests/test_pallas_warp.py runs it: same taps, products reassociated
    rs = np.random.RandomState(2)
    image = rs.randn(1, 48, 80, 64).astype(np.float32)
    coarse = rs.randn(1, 6, 10, 2).astype(np.float32)
    flow = np.asarray(jax.image.resize(coarse, (1, 48, 80, 2), "linear")) * 3.0
    assert int(window_overflow_blocks(image.shape, flow)) == 0
    got = warp_plain(torch.from_numpy(image), torch.from_numpy(flow)).numpy()
    want = np.asarray(warp_window_pallas(image, flow, True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_zero_flow_is_identity_and_integer_shift_moves_rows():
    # exact except on the last row and column, where the clamped floor makes
    # the weight 1 and the lerp (b - a) + a rounds once
    rs = np.random.RandomState(3)
    image = torch.from_numpy(rs.randn(1, 6, 8, 4).astype(np.float32))
    flow = torch.zeros(1, 6, 8, 2)
    torch.testing.assert_close(warp_plain(image, flow), image, rtol=0, atol=1e-6)
    torch.testing.assert_close(warp_plain(image, flow)[:, :-1, :-1], image[:, :-1, :-1],
                               rtol=0, atol=0)
    flow[..., 0] = 1.0      # out(y) = image(y - 1)
    torch.testing.assert_close(warp_plain(image, flow)[:, 1:, :-1], image[:, :-1, :-1],
                               rtol=0, atol=0)


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    rs = np.random.RandomState(4)
    image = torch.from_numpy(rs.randn(1, 6, 8, 4).astype(np.float32))
    flow = torch.from_numpy(clamp_flow(rs, 1, 6, 8))
    before = dense_image_warp.launches
    torch.testing.assert_close(dense_image_warp(image, flow), warp_plain(image, flow),
                               rtol=0, atol=0)
    assert dense_image_warp.launches == before

