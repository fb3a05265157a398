"""Host-side visualization helpers of the dense evaluation path, copied
from unsupervised_detection_tpu/utils/visualization.py (reference
general_utils.py:23-51): the un-normalizers for images and masks. numpy and
cv2 only. The JAX module's flow and error-map visualizers have no caller
in the port yet and are not copied.
"""

from __future__ import annotations

import cv2
import numpy as np


def postprocess_image(image: np.ndarray) -> np.ndarray:
    """[-0.5, 0.5] RGB -> uint8 BGR (general_utils.py:23-35)."""
    un_normalized = np.asarray((image + 0.5) * 255, np.uint8)
    return cv2.cvtColor(un_normalized, cv2.COLOR_RGB2BGR)


def postprocess_mask(mask: np.ndarray) -> np.ndarray:
    """[0,1] mask -> green-channel uint8 image (general_utils.py:37-51)."""
    un_normalized = np.asarray(mask * 255.0, np.uint8)
    tile = np.zeros_like(un_normalized, dtype=np.uint8)
    return np.concatenate((tile, un_normalized, tile), axis=-1)
