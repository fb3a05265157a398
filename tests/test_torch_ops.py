"""The port's tensor ops (resize, flow standardization, metrics) against
their JAX counterparts on the same numpy inputs, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unsupervised_detection_tpu.ops import flow as jflow
from unsupervised_detection_tpu.ops import metrics as jmetrics
from unsupervised_detection_tpu.ops import resize as jresize
from unsupervised_detection_tpu_torch.ops import flow as tflow
from unsupervised_detection_tpu_torch.ops import metrics as tmetrics
from unsupervised_detection_tpu_torch.ops import resize as tresize

# float32 resize: the interpolation matrices are built by the same float32
# arithmetic (asserted bit-equal below); the two einsums sum in other
# orders, so outputs agree to float32 rounding of O(1) values.
RESIZE_ATOL = 1e-5


def _rand(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, size=shape).astype(np.float32)


SIZES = [
    ((384, 640), (192, 384)),   # working-resolution downsample
    ((48, 96), (192, 384)),     # PWC final x4 upsample
    ((12, 24), (24, 48)),
    ((7, 13), (5, 3)),          # odd sizes
]


@pytest.mark.parametrize("in_hw,out_hw", SIZES)
@pytest.mark.parametrize("align_corners", [False, True])
def test_weight_builders_bit_equal(in_hw, out_hw, align_corners):
    for n_in, n_out in zip(in_hw, out_hw):
        np.testing.assert_array_equal(
            tresize.bilinear_resize_weights_np(n_in, n_out, align_corners),
            jresize.bilinear_resize_weights_np(n_in, n_out, align_corners))
        np.testing.assert_array_equal(
            tresize.nearest_resize_weights_np(n_in, n_out, align_corners),
            np.asarray(jresize.nearest_resize_matrix(n_in, n_out, align_corners)))
        np.testing.assert_array_equal(
            tresize._composed_bilinear_weights_np(n_in, 4 * n_in, n_out),
            jresize._composed_bilinear_weights_np(n_in, 4 * n_in, n_out))


@pytest.mark.parametrize("in_hw,out_hw", SIZES)
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    x = _rand((2, *in_hw, 3))
    got = tresize.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("in_hw,out_hw", SIZES)
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_nearest_matches_jax(in_hw, out_hw, align_corners):
    # one-hot matrices select a single source value: exact
    x = _rand((2, *in_hw, 1), seed=1)
    got = tresize.resize_nearest(torch.from_numpy(x), out_hw, align_corners).numpy()
    want = np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw, align_corners))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fraction", [0.85, 0.9, 1.0])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_central_crop_resize_matches_jax(fraction, method):
    x = _rand((1, 128, 192, 3), seed=3)
    got = tresize.central_crop_resize(torch.from_numpy(x), fraction, method).numpy()
    want = np.asarray(jresize.central_crop_resize(jnp.asarray(x), fraction, method))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("in_hw,mid_hw,out_hw", [
    ((96, 160), (384, 640), (192, 384)),   # flagship bf16 fused flow resize
    ((32, 48), (128, 192), (64, 96)),
])
def test_resize_bilinear_composed_matches_jax(in_hw, mid_hw, out_hw):
    x = _rand((2, *in_hw, 2), seed=4)
    got = tresize.resize_bilinear_composed(torch.from_numpy(x), mid_hw, out_hw).numpy()
    want = np.asarray(jresize.resize_bilinear_composed(jnp.asarray(x), mid_hw, out_hw))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_resize_bfloat16_matches_jax():
    # bfloat16 in, bfloat16 matrices (as the JAX path casts them): the two
    # frameworks round the intermediate product at other places, so agree
    # to a few bfloat16 ulps of O(1) values.
    x = _rand((2, 48, 96, 2), seed=5)
    got = tresize.resize_bilinear(torch.from_numpy(x).bfloat16(), (192, 384)).float().numpy()
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x, jnp.bfloat16),
                                              (192, 384)).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=3 * 2.0**-8)


def test_standardize_flow_matches_jax():
    # float32 means and variances over 64x96 pixels, summed in other orders
    flow = _rand((3, 64, 96, 2), seed=6) * 7.0 + 1.5
    got = tflow.standardize_flow(torch.from_numpy(flow)).numpy()
    want = np.asarray(jflow.standardize_flow(jnp.asarray(flow)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _masks(seed=7, b=6, h=32, w=48):
    """Soft masks covering the metric branches: a centre blob (kept), a
    border-heavy mask (flipped), an empty mask, a full mask."""
    rs = np.random.RandomState(seed)
    pred = rs.rand(b, h, w, 1).astype(np.float32) * 0.05
    pred[0, 8:20, 10:30] = 0.9
    pred[1] = 0.8
    pred[1, 10:20, 15:30] = 0.0
    pred[3] = 1.0
    pred[4] = rs.rand(h, w, 1)
    gt = np.zeros((b, h, w, 1), np.float32)
    gt[0, 6:18, 12:28] = 1.0
    gt[1, 10:20, 15:30] = 0.7
    gt[4, 2:30, 2:40] = rs.rand(28, 38, 1)
    return pred, gt


def test_boundary_score_and_disambiguation_match_jax():
    pred, _ = _masks()
    binary = (pred > 0.1).astype(np.float32)
    np.testing.assert_allclose(
        tmetrics.boundary_score(torch.from_numpy(binary)).numpy(),
        np.asarray(jmetrics.boundary_score(jnp.asarray(binary))), rtol=1e-6)
    np.testing.assert_array_equal(
        tmetrics.disambiguate_forward_background(torch.from_numpy(pred)).numpy(),
        np.asarray(jmetrics.disambiguate_forward_background(jnp.asarray(pred))))


def test_iou_and_compute_all_iou_match_jax():
    pred, gt = _masks(seed=8)
    a, b = (pred > 0.5), (gt > 0.0)
    np.testing.assert_allclose(tmetrics.iou(torch.from_numpy(b), torch.from_numpy(a)).numpy(),
                               np.asarray(jmetrics.iou(jnp.asarray(b), jnp.asarray(a))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tmetrics.compute_all_iou(torch.from_numpy(pred), torch.from_numpy(gt)).numpy(),
        np.asarray(jmetrics.compute_all_iou(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-6)


def test_mae_and_eval_iou_mae_match_jax():
    # float32 means over ~9k values, summed in other orders: rtol 1e-5
    pred, gt = _masks(seed=9)
    np.testing.assert_allclose(
        tmetrics.mae(torch.from_numpy(gt), torch.from_numpy(pred)).item(),
        float(jmetrics.mae(jnp.asarray(gt), jnp.asarray(pred))), rtol=1e-5)
    got_iou, got_mae = tmetrics.eval_iou_mae(torch.from_numpy(pred), torch.from_numpy(gt))
    want_iou, want_mae = jmetrics.eval_iou_mae(jnp.asarray(pred), jnp.asarray(gt))
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou), rtol=1e-6)
    np.testing.assert_allclose(got_mae.numpy(), np.asarray(want_mae), rtol=1e-5)
