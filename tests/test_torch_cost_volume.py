"""The port's cost volume (plain PyTorch version, which the CUDA kernel is
held against on the card) against the JAX package's XLA formulation and its
Pallas kernel run through the Pallas interpreter, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unsupervised_detection_tpu.ops.cost_volume import _cost_volume_xla
from unsupervised_detection_tpu.ops.pallas.cost_volume_kernel import cost_volume_pallas
from unsupervised_detection_tpu_torch.ops.cost_volume import cost_volume, cost_volume_plain


# float32: channel sums of C products in other orders, costs of magnitude
# ~1/sqrt(C) -> 1e-5 absolute. bfloat16: the JAX XLA path multiplies and sums
# in bfloat16 and scales by a bfloat16 1/C, the port sums in float32 and
# rounds once -> a few bfloat16 ulps of the largest cost.
F32_ATOL = 1e-5
BF16_RTOL_OF_MAX = 4 * 2.0**-8


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("c", [16, 196])
def test_plain_matches_xla_float32(r, c):
    a, b = _inputs((2, 7, 11, c), seed=c + r)
    got = cost_volume_plain(torch.from_numpy(a), torch.from_numpy(b), r).numpy()
    want = np.asarray(_cost_volume_xla(jnp.asarray(a), jnp.asarray(b), r))
    assert got.shape == want.shape == (2, 7, 11, (2 * r + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("c", [16, 196])
def test_plain_matches_xla_bfloat16(r, c):
    a, b = _inputs((2, 6, 10, c), seed=2 * c + r)
    got = cost_volume_plain(torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16(), r)
    assert got.dtype == torch.bfloat16
    want = np.asarray(_cost_volume_xla(jnp.asarray(a, jnp.bfloat16),
                                       jnp.asarray(b, jnp.bfloat16), r).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_RTOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("c", [16, 196])
def test_plain_matches_pallas_interpret(r, c):
    # the TPU kernel itself, through the Pallas interpreter (as
    # tests/test_pallas_costvol.py runs it); float32 accumulation both sides
    a, b = _inputs((2, 12, 16, c), seed=3 * c + r)
    got = cost_volume_plain(torch.from_numpy(a), torch.from_numpy(b), r).numpy()
    want = np.asarray(cost_volume_pallas(jnp.asarray(a), jnp.asarray(b), r, True))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_pallas_interpret_bfloat16():
    a, b = _inputs((1, 12, 16, 32), seed=5)
    got = cost_volume_plain(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(), 4)
    want = np.asarray(cost_volume_pallas(jnp.asarray(a, jnp.bfloat16),
                                         jnp.asarray(b, jnp.bfloat16), 4, True)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_RTOL_OF_MAX * np.abs(want).max())


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    a, b = _inputs((1, 6, 10, 8), seed=6)
    before = cost_volume.launches
    got = cost_volume(torch.from_numpy(a), torch.from_numpy(b), 2)
    torch.testing.assert_close(got, cost_volume_plain(torch.from_numpy(a), torch.from_numpy(b), 2),
                               rtol=0, atol=0)
    assert cost_volume.launches == before


def test_centre_offset_is_self_correlation():
    # offset (r, r) is the unshifted product: mean_c c1*warp, then LeakyReLU
    a, b = _inputs((1, 5, 7, 12), seed=7)
    got = cost_volume_plain(torch.from_numpy(a), torch.from_numpy(b), 2)[..., 12].numpy()
    want = (a * b).mean(-1)
    want = np.where(want >= 0, want, 0.1 * want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

