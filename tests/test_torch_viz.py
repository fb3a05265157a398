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
