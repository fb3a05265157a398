"""Host-side visualization helpers, copied from
unsupervised_detection_tpu/utils/visualization.py (reference
general_utils.py:5-87): the un-normalizers for images, masks and flows of
the dense evaluation path, and the error-map heatmap overlay used for
qualitative analysis of per-box reconstruction losses. numpy and cv2 only.
"""

from __future__ import annotations

from typing import Sequence

import cv2
import numpy as np


def postprocess_flow(flow: np.ndarray) -> np.ndarray:
    """First flow channel as a grayscale BGR image (general_utils.py:5-21).

    The reference's quirk is kept: it ADDS the minimum instead of
    subtracting it and divides by max_rescaled twice, so for flows with
    negative values the uint8 cast wraps. `ops.flow.flow_to_image` is the
    faithful colorization."""
    f = flow[:, :, 0]
    rescaled = f + np.min(f)
    max_rescaled = np.max(rescaled)
    normalized = rescaled / max_rescaled
    normalized = np.asarray(normalized / max_rescaled * 255, np.uint8)
    return cv2.cvtColor(normalized, cv2.COLOR_GRAY2BGR)


def postprocess_image(image: np.ndarray) -> np.ndarray:
    """[-0.5, 0.5] RGB -> uint8 BGR (general_utils.py:23-35)."""
    un_normalized = np.asarray((image + 0.5) * 255, np.uint8)
    return cv2.cvtColor(un_normalized, cv2.COLOR_RGB2BGR)


def postprocess_mask(mask: np.ndarray) -> np.ndarray:
    """[0,1] mask -> green-channel uint8 image (general_utils.py:37-51)."""
    un_normalized = np.asarray(mask * 255.0, np.uint8)
    tile = np.zeros_like(un_normalized, dtype=np.uint8)
    return np.concatenate((tile, un_normalized, tile), axis=-1)


def generate_error_map(image: np.ndarray, losses: Sequence[float],
                       box_length: int) -> np.ndarray:
    """Overlay a per-box loss heatmap on the image (general_utils.py:53-87).

    Args:
        image: (H, W, 3) RGB in [-0.5, 0.5].
        losses: one loss per box, row-major over the box grid.
        box_length: box side in pixels.
    """
    box_length = int(box_length)
    n_boxes = (image.shape[0] // box_length) * (image.shape[1] // box_length)
    if n_boxes != len(losses):
        raise ValueError(f"{len(losses)} losses for {n_boxes} boxes of {box_length} px")

    img_width = int(np.floor(image.shape[1] / box_length) * box_length)
    img_height = int(np.floor(image.shape[0] / box_length) * box_length)
    image = image[:img_height, :img_width]

    heatmap = np.zeros((img_height, img_width))
    i = 0
    for y in range(0, img_height, box_length):
        for x in range(0, img_width, box_length):
            heatmap[y : y + box_length, x : x + box_length] = losses[i]
            i += 1
    heatmap = np.asarray(heatmap / np.max(heatmap) * 255, dtype=np.uint8)
    heatmap_img = cv2.applyColorMap(heatmap, cv2.COLORMAP_JET)
    return cv2.addWeighted(heatmap_img, 0.5, postprocess_image(image), 0.5, 0)
