"""Dense CRF refinement (mean field, bilateral pairwise).

Reproduces the reference CRF stage (post_processing/crf_refine.py):
  * unary: -log of the gaussian-blurred (sigma=gauss_k), max-normalized,
    clipped soft mask (refine, crf_refine.py:110-122);
  * pairwise: one bilateral kernel on (x/sxy, y/sxy, r/srgb, g/srgb, b/srgb)
    with Potts compatibility `compat` and symmetric kernel normalization
    (pydensecrf addPairwiseBilateral defaults);
  * 50 mean-field iterations, argmax labeling;
  * candidate selection among {soft score, forward avg, backward avg} by
    overlap with GT — the reference's benchmark-only step
    (crf_refine.py:44-52);
  * `run_crf_original_resolution` re-embeds the 0.9-crop mask into the raw
    frame before refining (crf_refine.py:65-108).

The filtering engine is the permutohedral lattice (permutohedral.py), the
same algorithm pydensecrf uses, or the native C++ solver
(native/densecrf.py). A copy of unsupervised_detection_tpu/postproc/crf.py,
which the port does not import; its native solver is built by the port's
binding at the first call that asks for it. Unlike the JAX package's,
`run_crf` and `run_crf_original_resolution` refine a tree's frames on
several host threads at once; each frame's output and the mean IoU are
those of the one-thread loop.
"""

from __future__ import annotations

import functools
import os
from concurrent import futures
from typing import Optional

import numpy as np
import scipy.io as sio
import torch
from scipy.ndimage import gaussian_filter

from .permutohedral import PermutohedralLattice

REFINE_ITERATIONS = 50


@functools.lru_cache(maxsize=1)
def _native_build():
    """(the native solver's module, None) once its library loads, built at
    the first call; (None, the reason) when the build fails. Cached, so
    per-frame calls do not retry a failing build."""
    from ..native import densecrf as native_crf

    try:
        native_crf.library()
    except (OSError, RuntimeError) as e:
        return None, "%s: %s" % (type(e).__name__, e)
    return native_crf, None


@functools.lru_cache(maxsize=1)
def _warn_numpy_engine(reason: str) -> None:
    print("WARNING: native dense-CRF unavailable (%s); using the "
          "numpy engine (~12x slower)" % reason)


def _native_backend(required: bool = False):
    """The native solver; None, with one warning, when it cannot be built,
    or a RuntimeError where it is `required`."""
    native_crf, reason = _native_build()
    if native_crf is None:
        if required:
            raise RuntimeError("native dense-CRF backend requested but unavailable "
                               "(%s)" % reason)
        _warn_numpy_engine(reason)
    return native_crf


def backend_name() -> str:
    """The engine `backend="auto"` runs: "native" or "numpy"."""
    return "numpy" if _native_build()[0] is None else "native"


def dense_crf_binary(unary: np.ndarray, image: np.ndarray, sxy: float,
                     srgb: float, compat: float,
                     n_iterations: int = REFINE_ITERATIONS,
                     backend: str = "auto") -> np.ndarray:
    """2-label dense CRF mean field with a bilateral pairwise kernel.

    Args:
        unary: (2, H, W) negative log probabilities.
        image: (H, W, 3) uint8 RGB.
        backend: "auto" (native C++ if built, else numpy), "native", "numpy".
    Returns:
        (2, H, W) final marginals Q.
    """
    if backend in ("auto", "native"):
        native_crf = _native_backend(required=backend == "native")
        if native_crf is not None:
            return native_crf.dense_crf_binary(
                unary, image, sxy, srgb, compat, n_iterations)
    h, w = image.shape[:2]
    n = h * w
    yy, xx = np.mgrid[0:h, 0:w]
    feats = np.stack(
        [xx.ravel() / sxy, yy.ravel() / sxy,
         image[..., 0].ravel() / srgb,
         image[..., 1].ravel() / srgb,
         image[..., 2].ravel() / srgb], axis=1,
    ).astype(np.float64)
    lattice = PermutohedralLattice(feats)

    # symmetric kernel normalization (pydensecrf NORMALIZE_SYMMETRIC)
    norm = lattice.compute(np.ones((n, 1)))
    inv_sqrt_norm = 1.0 / np.sqrt(np.maximum(norm, 1e-20))

    u = unary.reshape(2, n).T  # (n, 2)

    def expand_normalize(logits):
        logits = logits - logits.max(axis=1, keepdims=True)
        q = np.exp(logits)
        return q / q.sum(axis=1, keepdims=True)

    q = expand_normalize(-u)
    for _ in range(n_iterations):
        filtered = inv_sqrt_norm * lattice.compute(q * inv_sqrt_norm)
        # Potts compatibility mu = -compat on the diagonal: pairwise term
        # lowers the energy of agreeing labels.
        pairwise = -compat * filtered
        q = expand_normalize(-u - pairwise)
    return q.T.reshape(2, h, w)


def refine_mask(mask: np.ndarray, image: np.ndarray, gauss_k: float,
                sxy: float, srgb: float, compat: float,
                gt_mask: Optional[np.ndarray] = None):
    """Reference `refine` (crf_refine.py:110-138): build the unary from the
    blurred soft mask, run the CRF, return the argmax mask (+IoU if GT)."""
    u = gaussian_filter(mask.astype(np.float64), sigma=gauss_k)
    u = u / (np.max(u) + 1e-8)
    u = np.clip(u, 1e-6, 1.0 - 1e-6)
    uu = np.stack([1.0 - u, u], axis=0)
    uu = -np.log(uu)

    im = np.ascontiguousarray(image).astype(np.uint8)
    if im.ndim == 2:
        im = np.stack([im] * 3, axis=-1)
    q = dense_crf_binary(uu.astype(np.float32), im, sxy, srgb, compat)
    new_mask = np.argmax(q, axis=0).astype(np.float32)

    iou = None
    if gt_mask is not None:
        gt = gt_mask > 0.1
        bmask = new_mask > 0.1
        denom = np.float32(np.sum(gt | bmask))
        iou = float(np.float32(np.sum(gt & bmask)) / denom) if denom else 0.0
    return new_mask, iou


def select_candidate(pred_mask, pred_f, pred_b, gt_mask):
    """Best of {soft score, fwd avg, bwd avg} by GT overlap
    (crf_refine.py:44-52; benchmark-only: uses the ground truth)."""
    objscore_m = np.sum(pred_mask * gt_mask) / (np.sum(pred_mask) + 1e-8)
    objscore_f = np.sum(pred_f * gt_mask) / (np.sum(pred_f) + 1e-8)
    objscore_b = np.sum(pred_b * gt_mask) / (np.sum(pred_b) + 1e-8)
    if objscore_m >= objscore_f and objscore_m >= objscore_b:
        return pred_mask
    if objscore_f >= objscore_m and objscore_f >= objscore_b:
        return pred_f
    return pred_b


def _refine_frames(refine_frame, frames) -> float:
    """Mean of `refine_frame(*frame)`'s IoU over `frames`, the frames spread
    over the host threads PyTorch computes with (the native solver releases
    the interpreter lock while it runs); the IoUs are summed in frame order,
    so the mean does not depend on the thread count."""
    _native_build()     # build the solver once, before the threads need it
    workers = torch.get_num_threads()
    if workers > 1:
        with futures.ThreadPoolExecutor(workers) as pool:
            ious = list(pool.map(lambda frame: refine_frame(*frame), frames))
    else:
        ious = [refine_frame(*frame) for frame in frames]
    sum_iou = 0.0
    for iou in ious:
        sum_iou += iou
    return sum_iou / float(len(frames))


def _sequence_frames(path_soft: str, out_path: str) -> list:
    """(sequence, its soft-score directory, its output directory, frame
    index) for every frame of the soft-score tree; makes the output
    directories and prints each."""
    frames = []
    for seq in os.listdir(path_soft):
        seq_path = os.path.join(path_soft, seq)
        seq_len = len([f for f in os.listdir(seq_path) if f.endswith(".mat")])
        out_dir = os.path.join(out_path, seq)
        os.makedirs(out_dir, exist_ok=True)
        print(out_dir)
        frames += [(seq, seq_path, out_dir, k) for k in range(seq_len)]
    return frames


def run_crf(path_soft: str, sxy: float, srgb: float, scomp: float,
            gauss_k: float, out_path: str = "./post_processed_davis") -> float:
    """Per-frame CRF over the soft-score tree (crf_refine.py:9-63)."""

    def refine_frame(seq, seq_path, out_dir, k):
        result = sio.loadmat(os.path.join(seq_path, "result_%d.mat" % (k + 1)))
        pred_mask = np.float32(np.squeeze(result["pred_mask"]))
        pred_f = np.float32(np.squeeze(result["running_avg_f"]))
        pred_b = np.float32(np.squeeze(result["running_avg_b"]))
        image = result["img1"]
        gt_mask = np.float32(np.squeeze(result["gt_mask"]))

        mask = select_candidate(pred_mask, pred_f, pred_b, gt_mask)
        mask_new, iou_new = refine_mask(mask, np.squeeze(image), gauss_k,
                                        sxy, srgb, scomp, gt_mask)
        sio.savemat(
            os.path.join(out_dir, "result_%d.mat" % (k + 1)),
            {"gt_mask": gt_mask, "soft_mask": mask, "mask": mask_new},
        )
        return iou_new

    return _refine_frames(refine_frame, _sequence_frames(path_soft, out_path))


def run_crf_original_resolution(path_soft: str, path_img: str, path_gt: str,
                                sxy: float, srgb: float, scomp: float,
                                gauss_k: float,
                                out_path: str = "./post_processed_davis_original") -> float:
    """CRF at the raw 854x480 resolution (crf_refine.py:65-108): re-embed
    the 0.9-crop soft mask into the full frame, refine against the raw
    image."""
    import cv2

    def refine_frame(seq, seq_path, out_dir, k):
        result = sio.loadmat(os.path.join(seq_path, "result_%d.mat" % (k + 1)))
        soft_mask = np.float32(np.squeeze(result["soft_mask"]))

        image = cv2.cvtColor(
            cv2.imread(os.path.join(path_img, seq, "%05d.jpg" % k)),
            cv2.COLOR_BGR2RGB,
        )
        gt_mask = cv2.imread(os.path.join(path_gt, seq, "%05d.png" % k),
                             cv2.IMREAD_GRAYSCALE) / 255.0
        h_full, w_full = gt_mask.shape
        hh, ww = int(h_full * 0.9), int(w_full * 0.9)
        lo, hi = float(soft_mask.min()), float(soft_mask.max())
        scale = 255.0 / (hi - lo) if hi != lo else 1.0
        u8 = ((soft_mask - lo) * scale).astype(np.uint8)
        resized = cv2.resize(u8, (ww, hh), interpolation=cv2.INTER_LINEAR)
        resized = resized / (np.max(resized) + 1e-8)
        mask = np.zeros((h_full, w_full))
        dh, dw = (h_full - hh) // 2, (w_full - ww) // 2
        mask[dh : dh + hh, dw : dw + ww] = resized

        mask_new, iou_new = refine_mask(mask, image, gauss_k, sxy, srgb,
                                        scomp, gt_mask)
        sio.savemat(os.path.join(out_dir, "result_%d.mat" % (k + 1)),
                    {"mask": mask_new})
        return iou_new

    return _refine_frames(refine_frame, _sequence_frames(path_soft, out_path))
