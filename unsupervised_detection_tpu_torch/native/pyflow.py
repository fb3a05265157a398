"""ctypes binding of the native coarse2fine optical flow
(native/pyflow/coarse2fine.cpp, the pyflow.so equivalent), counterpart of
unsupervised_detection_tpu/native/pyflow.py. The library is built at the
first call (`library()`), not at import."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ._build import load_library


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The solver, built and loaded on the first call of the process."""
    lib = load_library("pyflow/coarse2fine.cpp", "coarse2fine")
    lib.coarse2fine_flow.restype = ctypes.c_int
    lib.coarse2fine_flow.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def coarse2fine_flow(im1: np.ndarray, im2: np.ndarray, alpha: float = 0.012,
                     ratio: float = 0.75, min_width: int = 20,
                     n_outer_fp_iterations: int = 7,
                     n_inner_fp_iterations: int = 1,
                     n_sor_iterations: int = 30, col_type: int = 0):
    """Dense flow from im1's grid into im2 (reference pyflow API:
    coarse2fine_flow(I2, I1, ...) maps I2 coordinates into I1).

    Args:
        im1, im2: (H, W, 3) or (H, W, 1)/(H, W) float images in [0, 1].
    Returns:
        (u, v, warped_im2): x/y displacement fields and im2 warped onto im1.
    """
    def prep(im):
        im = np.asarray(im, dtype=np.float64)
        if im.ndim == 2:
            im = im[..., None]
        return np.ascontiguousarray(im)

    im1 = prep(im1)
    im2 = prep(im2)
    if im1.shape != im2.shape:
        raise ValueError(f"coarse2fine_flow: frames {im1.shape} and {im2.shape} differ")
    h, w, c = im1.shape

    u = np.zeros((h, w), np.float64)
    v = np.zeros((h, w), np.float64)
    warped = np.zeros((h, w, c), np.float64)

    dp = ctypes.POINTER(ctypes.c_double)
    ret = library().coarse2fine_flow(
        im1.ctypes.data_as(dp), im2.ctypes.data_as(dp),
        h, w, c,
        alpha, ratio, min_width,
        n_outer_fp_iterations, n_inner_fp_iterations, n_sor_iterations,
        col_type,
        u.ctypes.data_as(dp), v.ctypes.data_as(dp), warped.ctypes.data_as(dp),
    )
    if ret != 0:
        raise RuntimeError(f"coarse2fine_flow failed with code {ret}")
    return u, v, warped
