"""Soft-score ensembling over temporal shifts and center crops.

Reproduces post_processing/generate_soft_score_from_buffer.py:16-125: loads
per-(shift, crop) .mat buffers, suppresses predictions whose border
occupancy fails the sanity threshold (0.6), re-embeds each crop's prediction
into the common 192x384 frame (`rectify_pred_mask`), sums the 16 ensemble
members, and min-max normalizes into a soft score. The legacy
scipy.misc.imresize in `rectify_pred_mask` operated on bytescaled uint8 —
we reproduce the bytescale + bilinear-uint8 behavior explicitly.

A copy of unsupervised_detection_tpu/postproc/soft_score.py, which the port
does not import.
"""

from __future__ import annotations

import os
from typing import Sequence

import cv2
import numpy as np
import scipy.io as sio

SANITY_THRESHOLD = 0.6
BASE_H = 192
BASE_W = 384
START_CROP = 85
END_CROP = 100
CROP_STEP = 5

# DAVIS2016 val sequences and frame counts hardcoded by the reference
# (generate_soft_score_from_buffer.py:9-14).
DAVIS_VAL_SEQ_NAMES = [
    "soapbox", "scooter-black", "parkour", "paragliding-launch",
    "motocross-jump", "libby", "kite-surf", "horsejump-high", "goat",
    "drift-straight", "drift-chicane", "dog", "dance-twirl", "cows",
    "car-shadow", "car-roundabout", "camel", "breakdance", "bmx-trees",
    "blackswan",
]
DAVIS_VAL_SEQ_NUM = [99, 43, 100, 80, 40, 49, 50, 50, 90, 50, 52, 60, 90,
                     104, 40, 75, 90, 84, 80, 50]


def sanity_check(mask: np.ndarray) -> float:
    """Border occupancy of a soft mask (soft-score variant of the boundary
    score; generate_soft_score_from_buffer.py:116-125)."""
    h, w = mask.shape[0], mask.shape[1]
    strips = [mask[0:2, :], mask[h - 2 : h, :], mask[:, 0:2], mask[:, w - 2 : w]]
    return float(sum(np.sum(s) for s in strips) / sum(s.size for s in strips))


def _imresize_uint8(arr: np.ndarray, size_hw) -> np.ndarray:
    """scipy.misc.imresize-compatible resize: bytescale to uint8 (min-max to
    0..255) then bilinear resize, returning uint8."""
    lo, hi = float(np.min(arr)), float(np.max(arr))
    scale = 255.0 / (hi - lo) if hi != lo else 1.0
    u8 = ((arr - lo) * scale).astype(np.uint8)
    return cv2.resize(u8, (size_hw[1], size_hw[0]), interpolation=cv2.INTER_LINEAR)


def rectify_pred_mask(pred_mask: np.ndarray, crop_ratio: float,
                      h: int = BASE_H, w: int = BASE_W) -> np.ndarray:
    """Map a prediction made on crop fraction `crop_ratio * base` back onto
    the base frame (generate_soft_score_from_buffer.py:96-114)."""
    if crop_ratio > 1:
        inv = 1.0 / crop_ratio
        hh, ww = int(h * inv), int(w * inv)
        oh, ow = int((h - hh) / 2), int((w - ww) / 2)
        pred_crop = pred_mask[oh : oh + hh, ow : ow + ww]
        rect = _imresize_uint8(pred_crop, (h, w)).astype(np.float64)
    else:
        rect = np.zeros((h, w))
        hh, ww = int(h * crop_ratio), int(w * crop_ratio)
        pred_crop = _imresize_uint8(pred_mask, (hh, ww)).astype(np.float64)
        oh, ow = max(int((h - hh) / 2), 0), max(int((w - ww) / 2), 0)
        rect[oh : oh + hh, ow : ow + ww] = pred_crop
    return rect / (np.max(rect) + 1e-6)


def buffer_to_soft_score(buffer_path: str, out_path: str, max_shift: int = 2,
                         base_crop: float = 90.0,
                         seq_names: Sequence[str] = None,
                         seq_num: Sequence[int] = None,
                         dprefix: str = "davis_shift",
                         run_propagation: bool = True,
                         flow_fn=None) -> None:
    """Ensemble the (shift x crop) buffer into per-frame soft scores
    (generate_soft_score_from_buffer.py:16-94), then optionally run the
    flow-propagated moving average (propagate.py)."""
    seq_names = list(seq_names if seq_names is not None else DAVIS_VAL_SEQ_NAMES)
    seq_num = list(seq_num if seq_num is not None else DAVIS_VAL_SEQ_NUM)

    for i, seq in enumerate(seq_names):
        out_dir = os.path.join(out_path, seq)
        os.makedirs(out_dir, exist_ok=True)
        print(out_dir)
        for k in range(1, seq_num[i] + 1):
            score = None
            img1 = None
            gt_mask = None
            for shift in range(1, max_shift + 1):
                r_b = sio.loadmat(os.path.join(
                    buffer_path, "%s_%d" % (dprefix, -shift), seq, "result_%d.mat" % k))
                r_f = sio.loadmat(os.path.join(
                    buffer_path, "%s_%d" % (dprefix, shift), seq, "result_%d.mat" % k))
                for crop in range(START_CROP, END_CROP + 1, CROP_STEP):
                    s_name = "pred_mask_%03d" % crop
                    s_b = np.squeeze(r_b[s_name]).astype(np.float64)
                    s_f = np.squeeze(r_f[s_name]).astype(np.float64)
                    # frame size from the buffer itself (the reference
                    # hardcodes 192x384; we support any working resolution)
                    base_h, base_w = s_b.shape[0], s_b.shape[1]

                    sani_b = sanity_check(s_b)
                    sani_f = sanity_check(s_f)
                    if sani_b >= SANITY_THRESHOLD and sani_f >= SANITY_THRESHOLD:
                        s_b = s_b * 0.0
                        s_f = s_f * 0.0
                    elif sani_b >= SANITY_THRESHOLD:
                        s_b = s_f
                    elif sani_f >= SANITY_THRESHOLD:
                        s_f = s_b

                    if shift == 1 and crop == base_crop:
                        contribution = s_b + s_f
                        img1 = ((r_f["img_1_%03d" % crop] + 0.5) * 255).astype("uint8")
                        gt_mask = r_f["gt_mask_%03d" % crop]
                    else:
                        ratio = crop / base_crop
                        contribution = (
                            rectify_pred_mask(s_b, ratio, base_h, base_w)
                            + rectify_pred_mask(s_f, ratio, base_h, base_w)
                        )
                    score = contribution if score is None else score + contribution

            lo, hi = np.min(score), np.max(score)
            pred_mask = (score - lo) / (hi - lo + 1e-6)
            sio.savemat(
                os.path.join(out_dir, "result_%d.mat" % k),
                {"pred_mask": pred_mask, "img1": img1, "gt_mask": gt_mask},
            )

    if run_propagation:
        from .propagate import propagate_sequences

        propagate_sequences(out_path, seq_names, seq_num, flow_fn=flow_fn)
