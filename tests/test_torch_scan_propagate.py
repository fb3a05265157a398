"""The port's device propagation (postproc/propagate.py::scan_propagate)
against the JAX package's `scan_propagate` and against the host loop, on
the CPU (the plain warp), from seeded numpy inputs.

Against JAX within 1e-6 absolute: both warp with `_warp_quad`'s taps and
arithmetic in float32 and normalize by the same maxima (the steps differ in
the last bit at most). Against the host loop within JAX's own 2e-5
(tests/test_postproc.py): cv2.remap samples in float32 too, but zero-fills
outside the frame where the warp clamps, so those cases keep every sample
inside the frame.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import torch_threads
from unsupervised_detection_tpu.postproc import propagate as jprop
from unsupervised_detection_tpu_torch.ops.warp import dense_image_warp
from unsupervised_detection_tpu_torch.postproc import propagate as tprop

_threads = torch_threads(2)


def _smooth_flows(rs, t, h, w, amplitude):
    """(t, h, w, 2) float32 flows: a constant drift plus a bilinear
    upsampling of a coarse random field, +- `amplitude` px."""
    import cv2

    out = np.empty((t, h, w, 2), np.float32)
    for i in range(t):
        coarse = rs.uniform(-amplitude, amplitude, (4, 6, 2)).astype(np.float32)
        out[i] = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR)
    return out


def _both(masks, flows, w_r=tprop.W_R):
    got = tprop.scan_propagate(torch.from_numpy(masks), torch.from_numpy(flows), w_r)
    want = np.asarray(jprop.scan_propagate(jnp.asarray(masks), jnp.asarray(flows), w_r))
    return got.numpy(), want


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_propagate_matches_jax(seed):
    rs = np.random.RandomState(seed)
    t, h, w = 6, 48, 80
    masks = rs.rand(t, h, w).astype(np.float32)
    flows = _smooth_flows(rs, t - 1, h, w, 3.0)
    got, want = _both(masks, flows)
    assert got.shape == (t, h, w) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_scan_propagate_clamps_like_jax_outside_the_frame():
    """Flows of 20-40 px push most samples past every edge: the warp's
    clamped floors and weights decide them on both sides."""
    rs = np.random.RandomState(2)
    t, h, w = 5, 48, 80
    masks = rs.rand(t, h, w).astype(np.float32)
    flows = _smooth_flows(rs, t - 1, h, w, 40.0)
    flows[1] = 25.0
    flows[2] = -30.0
    x = np.arange(w)[None, :] + flows[..., 0]
    y = np.arange(h)[:, None] + flows[..., 1]
    outside = (x < 0) | (x > w - 1) | (y < 0) | (y > h - 1)
    assert outside.mean() > 0.3
    got, want = _both(masks, flows)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("w_r", [0.5, 0.95])
def test_scan_propagate_weight(w_r):
    rs = np.random.RandomState(3)
    masks = rs.rand(4, 24, 32).astype(np.float32)
    flows = _smooth_flows(rs, 3, 24, 32, 2.0)
    got, want = _both(masks, flows, w_r)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    default, _ = _both(masks, flows)
    assert np.abs(got - default).max() > 1e-3


@pytest.mark.parametrize("case", ["jax_constant", "smooth_1_32"])
def test_scan_propagate_matches_host_loop(case):
    """JAX's own case (constant flow, zero on a 4-px border), and smooth
    flows in multiples of 1/32 px, zero on a 4-px border and at most 4 px,
    so no sample leaves the frame; the host loop is the port's `_ema_step`
    with cv2.remap warps."""
    rs = np.random.RandomState(7)
    t, h, w = (4, 24, 32) if case == "jax_constant" else (6, 48, 80)
    masks = rs.rand(t, h, w).astype(np.float32)
    if case == "jax_constant":
        flows = np.zeros((t - 1, h, w, 2), np.float32)
        flows[..., 0], flows[..., 1] = 1.5, -0.75
    else:
        flows = np.round(_smooth_flows(rs, t - 1, h, w, 4.0) * 32) / 32
    flows[:, :4] = flows[:, -4:] = 0.0
    flows[:, :, :4] = flows[:, :, -4:] = 0.0
    got = tprop.scan_propagate(torch.from_numpy(masks), torch.from_numpy(flows)).numpy()
    running = masks[0].astype(np.float64)
    want = [running]
    for i in range(1, t):
        u, v = (flows[i - 1, ..., c].astype(np.float64) for c in (0, 1))
        running = tprop._ema_step(masks[i - 1].astype(np.float64), running, u, v)
        want.append(running)
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=2e-5)


def test_scan_propagate_warps_twice_per_step_and_refuses_bad_inputs(monkeypatch):
    calls = []
    real = tprop.dense_image_warp
    monkeypatch.setattr(tprop, "dense_image_warp",
                        lambda image, flow: calls.append(tuple(image.shape)) or real(image, flow))
    masks, flows = torch.rand(5, 8, 10), torch.zeros(4, 8, 10, 2)
    out = tprop.scan_propagate(masks, flows)
    assert calls == [(1, 8, 10, 1)] * 8
    assert torch.equal(out[0], masks[0]) and dense_image_warp.launches == 0
    with pytest.raises(TypeError, match="float32"):
        tprop.scan_propagate(masks.double(), flows.double())
    with pytest.raises(ValueError, match="must be"):
        tprop.scan_propagate(masks, flows[:3])
