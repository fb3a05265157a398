"""Flow-propagated temporal moving average of soft masks, counterpart of
unsupervised_detection_tpu/postproc/propagate.py.

Reproduces post_processing/generate_soft_score_from_buffer.py:127-231: for
each consecutive frame pair, dense flow (Ce Liu coarse2fine in the
reference's pyflow.so) maps the previous frame's mask and the running
average into the current frame via bilinear remap; the running average is an
EMA with w_r = 0.85, max-normalized at every step. Forward and backward
passes are stored as `running_avg_f` / `running_avg_b` in the per-frame
.mat files.

Flow backends (flow_fn(im_a, im_b) -> (u, v), pyflow argument order:
correspondences from im_a's grid into im_b):
  * "pyflow"    -- the native C++ coarse2fine solver (native/pyflow.py);
  * "farneback" -- OpenCV, always available;
  * any callable -- e.g. `pwc_flow_fn`, the port's PWC net on the card.

The host functions (`farneback_flow` to `propagate_sequences`) are copies
of the JAX package's. `scan_propagate` is the same recurrence on the
device over given flows: a Python loop of device ops through
`ops/warp.py::dense_image_warp` (the kernel of csrc/warp.cu on CUDA
tensors), where JAX runs a `lax.scan` over its own warp.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import cv2
import numpy as np
import scipy.io as sio
import torch

from ..device import precision_scope, resolve_device
from ..models import PWCNet
from ..ops.warp import dense_image_warp

W_R = 0.85

# Reference pyflow options (generate_soft_score_from_buffer.py:130-138).
PYFLOW_OPTS = dict(alpha=0.012, ratio=0.75, min_width=20,
                   n_outer_fp_iterations=7, n_inner_fp_iterations=1,
                   n_sor_iterations=30, col_type=0)


def farneback_flow(im_a: np.ndarray, im_b: np.ndarray):
    """OpenCV Farneback flow with pyflow-compatible output convention."""
    g_a = cv2.cvtColor((im_a * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    g_b = cv2.cvtColor((im_b * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    flow = cv2.calcOpticalFlowFarneback(
        g_a, g_b, None, pyr_scale=0.5, levels=5, winsize=15, iterations=3,
        poly_n=5, poly_sigma=1.2, flags=0,
    )
    return flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)


def pyflow_flow(im_a: np.ndarray, im_b: np.ndarray):
    """Native C++ coarse2fine variational flow (Ce Liu), matching the
    reference pyflow.so call (generate_soft_score_from_buffer.py:165-167)."""
    from ..native import pyflow

    return pyflow.coarse2fine_flow(im_a, im_b, **PYFLOW_OPTS)[:2]


def get_flow_fn(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn == "pyflow":
        return pyflow_flow
    if name_or_fn == "farneback":
        return farneback_flow
    raise ValueError(f"Unknown flow backend {name_or_fn!r}")


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Source index of each of n + pad positions under numpy's "reflect"
    padding at the end of an axis of n (period 2(n - 1), edge not
    repeated)."""
    j = np.arange(n + pad) % max(2 * (n - 1), 1)
    return np.where(j >= n, 2 * (n - 1) - j, j)


def pwc_flow_fn(ckpt_path: str, search_range: int = 4, device=None):
    """The port's PWC net as a propagation flow backend (the role pyflow.so
    plays in the reference: frame-to-frame dense correspondence), on
    `device` (None is the card, and raises without one; float32 with TF32
    off).

    Returns a closure with this module's flow_fn contract: (u, v) on im_a's
    grid pointing into im_b, float64 numpy. PWC(I1, I2) reports F with
    I2(p) = I1(p + F(p)), so F = PWC(im_b, im_a) lives on im_a's grid and
    points into im_b: u = F[..., 1], v = F[..., 0]. Frames ((H, W, 3) in
    [0, 1]) are reflect-padded to a multiple of 2**pyr_lvls and the flow is
    cropped back (numpy's "reflect", repeated where the pad reaches past the
    frame). `ckpt_path` is a PWC scope save of the port, a full training
    save or a TF1 bundle's prefix (the reference's PWC bundles are r=4);
    its search range must be `search_range`. The weights load once; the net
    takes every padded shape."""
    from ..train.checkpoint import restore_params_scope

    dev = resolve_device(device)
    pwc = PWCNet(search_range=search_range).to(dev).eval()
    restore_params_scope(ckpt_path, pwc, "pwc_params")
    mult = 2**pwc.pyr_lvls

    def prep(im: np.ndarray, ph: int, pw: int) -> torch.Tensor:
        h, w = im.shape[:2]
        x = np.asarray(im, np.float32) - np.float32(0.5)
        x = x[_reflect_index(h, ph)][:, _reflect_index(w, pw)]
        return torch.from_numpy(np.ascontiguousarray(x[None])).to(dev)

    @torch.inference_mode()
    def flow_fn(im_a: np.ndarray, im_b: np.ndarray):
        h, w = im_a.shape[:2]
        ph, pw = (mult - h % mult) % mult, (mult - w % mult) % mult
        with precision_scope(torch.float32):
            flow = pwc(prep(im_b, ph, pw), prep(im_a, ph, pw))
        f = flow[0, :h, :w].cpu().numpy()
        return f[..., 1].astype(np.float64), f[..., 0].astype(np.float64)

    return flow_fn


def warp_with_flow(mask: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """cv2.remap-equivalent bilinear warp: out(x, y) = mask(x+u, y+v),
    zero outside (cv2 BORDER_CONSTANT default)."""
    h, w = mask.shape[:2]
    map_x = (np.arange(w)[None, :] + u).astype(np.float32)
    map_y = (np.arange(h)[:, None] + v).astype(np.float32)
    return cv2.remap(mask.astype(np.float32), map_x, map_y, cv2.INTER_LINEAR)


def _ema_step(prev_mask, running_avg, u, v):
    """One propagation step (generate_soft_score_from_buffer.py:174-181)."""
    warped = warp_with_flow(prev_mask, u, v)
    warped = warped / (np.max(warped) + 1e-8)
    running_avg = warp_with_flow(running_avg, u, v)
    running_avg = running_avg / (np.max(running_avg) + 1e-8)
    running_avg = (1 - W_R) * warped + W_R * running_avg
    return running_avg / (np.max(running_avg) + 1e-8)


def propagate_masks(masks: Sequence[np.ndarray], images: Sequence[np.ndarray],
                    flow_fn=None, backward: bool = False) -> List[np.ndarray]:
    """Pure-array propagation over one sequence; returns the running averages.

    Args:
        masks: per-frame soft masks (float, [0,1]).
        images: per-frame uint8 or [0,1] float RGB frames.
        backward: run the reverse-time pass.
    """
    flow_fn = get_flow_fn(flow_fn or "farneback")
    imgs = [
        (im.astype(np.float64) / 255.0 if im.dtype == np.uint8 else im)
        for im in images
    ]
    order = range(len(masks) - 1, -1, -1) if backward else range(len(masks))
    out = [None] * len(masks)
    running = None
    prev_idx = None
    for idx in order:
        if running is None:
            running = np.squeeze(masks[idx]).astype(np.float64)
        else:
            # flow from the current frame's grid into the previous frame
            u, v = flow_fn(imgs[idx], imgs[prev_idx])
            running = _ema_step(np.squeeze(masks[prev_idx]), running, u, v)
        out[idx] = running
        prev_idx = idx
    return out


def propagate_sequences(out_path: str, seq_names: Sequence[str],
                        seq_num: Sequence[int], flow_fn=None) -> None:
    """File-level propagation matching the reference driver: reads the
    soft-score result_<k>.mat files, adds running_avg_f / running_avg_b."""
    flow_fn = get_flow_fn(flow_fn or "farneback")
    for i, seq in enumerate(seq_names):
        out_dir = os.path.join(out_path, seq)
        print(out_dir)
        names = [os.path.join(out_dir, "result_%d.mat" % k)
                 for k in range(1, seq_num[i] + 1)]
        mats = [sio.loadmat(n) for n in names]
        masks = [np.squeeze(m["pred_mask"]).astype(np.float64) for m in mats]
        images = [np.squeeze(m["img1"]) for m in mats]
        forward = propagate_masks(masks, images, flow_fn, backward=False)
        backward = propagate_masks(masks, images, flow_fn, backward=True)
        for m, name, f_avg, b_avg in zip(mats, names, forward, backward):
            m["running_avg_f"] = f_avg
            m["running_avg_b"] = b_avg
            sio.savemat(name, m)


def scan_propagate(masks: torch.Tensor, flows: torch.Tensor, w_r: float = W_R) -> torch.Tensor:
    """The propagation recurrence on the device over given flows, as the
    JAX package's `scan_propagate`. `flows` holds per-step (u, v) maps from
    frame t's grid into frame t-1 (the host loop's convention).

    Args:
        masks: (T, H, W) float32 soft masks.
        flows: (T-1, H, W, 2) float32, channel 0 = u (x displacement),
            channel 1 = v (y displacement), on the masks' device.
    Returns:
        (T, H, W) running averages (forward direction).

    Each step warps the previous mask and the running average (two calls
    of `dense_image_warp` at B = 1, C = 1: 2(T-1) kernel launches on CUDA
    tensors) and max-normalizes after each of its three updates. The
    warp's border is the edge clamp, where the host loop's cv2.remap fills
    zeros. Nothing in the loop waits for the device.
    """
    if masks.dtype != torch.float32 or flows.dtype != torch.float32:
        raise TypeError(f"scan_propagate: masks {masks.dtype} and flows {flows.dtype}; "
                        "both must be float32")
    t, h, w = masks.shape
    if tuple(flows.shape) != (t - 1, h, w, 2):
        raise ValueError(f"scan_propagate: flows {tuple(flows.shape)} must be "
                         f"{(t - 1, h, w, 2)} for masks {tuple(masks.shape)}")

    def warp(m, uv):
        # dense_image_warp samples at (y - flow_y, x - flow_x); remap samples
        # at (y + v, x + u): negate and swap into (dy, dx) channels
        flow_yx = torch.stack([-uv[..., 1], -uv[..., 0]], dim=-1)
        return dense_image_warp(m[None, :, :, None].contiguous(), flow_yx[None])[0, :, :, 0]

    running = masks[0]
    out = [running]
    for step in range(t - 1):
        uv = flows[step]
        warped = warp(masks[step], uv)
        warped = warped / (torch.max(warped) + 1e-8)
        running = warp(running, uv)
        running = running / (torch.max(running) + 1e-8)
        running = (1 - w_r) * warped + w_r * running
        running = running / (torch.max(running) + 1e-8)
        out.append(running)
    return torch.stack(out)
