"""The port's host visualizers of the dense evaluation path
(utils/visualization.py) against the JAX package's, on the CPU, from seeded
numpy inputs: bit-equal."""

import numpy as np
import pytest

from unsupervised_detection_tpu.utils import visualization as jviz
from unsupervised_detection_tpu_torch.utils import visualization as tviz


@pytest.mark.parametrize("seed", [2, 3])
def test_postprocess_image_and_mask_bit_equal(seed):
    rs = np.random.RandomState(seed)
    image = rs.rand(16, 24, 3).astype(np.float32) - 0.5
    mask = rs.rand(16, 24, 1).astype(np.float32)
    np.testing.assert_array_equal(tviz.postprocess_image(image), jviz.postprocess_image(image))
    np.testing.assert_array_equal(tviz.postprocess_mask(mask), jviz.postprocess_mask(mask))
    binary = mask > 0.5     # the dense path's overlay takes the binary annotation
    np.testing.assert_array_equal(tviz.postprocess_mask(binary), jviz.postprocess_mask(binary))


@pytest.mark.parametrize("low", [0.0, 0.5, -2.0, -7.5])
def test_postprocess_flow_bit_equal(low):
    """Positive flows, and negative ones, where the reference's added
    minimum makes the uint8 cast wrap."""
    rs = np.random.RandomState(4)
    flow = (low + 6.0 * rs.rand(16, 24, 2)).astype(np.float32)
    got = tviz.postprocess_flow(flow)
    assert got.shape == (16, 24, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jviz.postprocess_flow(flow))


@pytest.mark.parametrize("hw,box", [((32, 48), 8), ((37, 50), 12)])
def test_generate_error_map_bit_equal(hw, box):
    rs = np.random.RandomState(5)
    image = rs.rand(*hw, 3).astype(np.float32) - 0.5
    losses = list(rs.rand((hw[0] // box) * (hw[1] // box)))
    got = tviz.generate_error_map(image, losses, box)
    np.testing.assert_array_equal(got, jviz.generate_error_map(image, losses, box))
    with pytest.raises(ValueError, match="losses"):
        tviz.generate_error_map(image, losses[:-1], box)
