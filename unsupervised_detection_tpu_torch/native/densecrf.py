"""ctypes binding of the native dense-CRF mean-field solver
(native/densecrf/densecrf.cpp), counterpart of
unsupervised_detection_tpu/native/densecrf.py. The library is built at the
first call (`library()`), not at import."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ._build import load_library


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The solver, built and loaded on the first call of the process."""
    lib = load_library("densecrf/densecrf.cpp", "densecrf")
    lib.dense_crf_binary.restype = ctypes.c_int
    lib.dense_crf_binary.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def dense_crf_binary(unary: np.ndarray, image: np.ndarray, sxy: float,
                     srgb: float, compat: float, n_iterations: int = 50):
    """2-label mean-field dense CRF (same contract as
    postproc.crf.dense_crf_binary).

    Args:
        unary: (2, H, W) negative log probabilities.
        image: (H, W, 3) uint8 RGB.
    Returns:
        (2, H, W) marginals.
    """
    h, w = image.shape[:2]
    if image.shape != (h, w, 3) or unary.shape != (2, h, w):
        raise ValueError(f"dense_crf_binary: unary {unary.shape} and image {image.shape} "
                         "must be (2, H, W) and (H, W, 3)")
    unary_f = np.ascontiguousarray(unary.reshape(2, h * w), dtype=np.float32)
    image_u = np.ascontiguousarray(image, dtype=np.uint8)
    q = np.zeros((2, h * w), np.float32)
    ret = library().dense_crf_binary(
        unary_f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        image_u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, sxy, srgb, compat, n_iterations,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if ret != 0:
        raise RuntimeError(f"dense_crf_binary failed with code {ret}")
    return q.reshape(2, h, w)
