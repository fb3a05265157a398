#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`unsupervised_detection_tpu_torch`).

    python3 chip_smoke.py                      # needs one CUDA card
    python3 chip_smoke.py --times [--root DIR] # kernel times only

Phases, in order, each printed with its wall seconds:

* card    -- the card's name and power limit from nvidia-smi;
* build   -- the CUDA kernels of csrc/, one nvcc per source started together
             (seconds, and ptxas' registers / spills / shared memory);
* kernels -- each kernel against its plain PyTorch version on the card: the
             cost volume at the five PWC level shapes of a 384x640 frame and
             at ragged shapes (1x1 and 2x3 levels, W, H and C off every tile
             and chunk, odd C, batch 1), r=4 and r=2; the warp at L5..L2 and
             ragged shapes (C=1, C % 8 != 0) with flows that drive taps past
             every clamp; the tile copy on both axes at offset 2; in float32
             and bfloat16, with the stated tolerance; both again at the train
             phase's level shapes (batch 16, r=2); the two backward kernels
             against their plain backwards at the five levels at batch 16,
             r=4 and r=2, and at the ragged shapes (the cost volume's must
             also give the same bits in two calls and slope 1 at exactly
             zero costs), the warp's with clamp-driving, zero and far
             (40-60 px) flows. Then each kernel's time at batch 8 (the
             backward kernels' at batch 16, r=4): CUDA events over 20 back-to-back calls (`ms`, host
             overhead included) and the kernel's own device time per launch
             from torch.profiler over 20 launches (`device_ms`), beside its
             bound, the share of the bound, its plain version's time and a
             yardstick PyTorch call where one exists;
* path    -- the flagship forward (`benchlib.build_forward`) and
             `Evaluator.infer_metrics` at full width (reader 384x640, working
             192x384, PWC 6 levels r=4, generator cnum 32) with seeded random
             weights, batch 8, float32 (TF32 off) and bfloat16: launch counts
             per forward (5 cost volume, 4 warp), the float32 card mask
             against the same forward on the CPU for one frame pair, and
             frames/s from CUDA events;
* eval    -- the evaluation entry point, `evaluate_dataset`, at full width
             with PWC r=2 (the flagship checkpoint's range) and seeded random
             weights, batch 8, fed through its batch-iterable seam with
             DAVIS-shaped raw-mode batches made in numpy (2 categories x 10
             frames of uint8 480x854 moving textured squares, 0/255 masks:
             20 samples, 3 batches, the last one wrapped): launch counts per
             batch (5 cost volume, 4 warp), float32 card against the same
             evaluation on the CPU (every category's IoU/MAE and the dataset
             IoU/MAE), bfloat16 card dataset IoU and MAE against float32
             card, a bfloat16 run with the central crop skipped that these
             limits must flag, no tile-copy launch, and frames/s of the whole loop (the host pipeline's threads and
             prefetch, feeding and bookkeeping included; frames come from
             arrays, not decoded files); and whether cv2 and PIL import on
             this machine;
* train   -- the two-player training game at full width (reader 384x640,
             working 192x384, PWC 6 levels r=2, generator cnum 32, recover
             f=0.25) with seeded random weights: one `generator_step` and one
             `recover_step` at batch 2 in float32 (TF32 off) on the card and
             on the CPU from the same weights and augmentation draws (the 8
             losses, the stepped net's gradients and, where those fix them,
             its deltas within the stated limits, with the share of elements
             whose deltas are held; the other net and its Adam count
             unchanged, the shared Adam step advanced); 2 cycles (8
             sub-steps) at batch 16 in float32 and bfloat16 with 5
             cost-volume, 4 warp and 0 tile-copy launches per sub-step,
             finite losses, ms per generator and per recover step (CUDA
             events), samples/s, the device's busy share and the kernels'
             device time over one cycle (torch.profiler), and each kernel
             against its plain version on the inputs PWC gives it in one
             more sub-step; then the train CLI through `main(argv)`
             on a DAVIS-layout tree of JPEGs written with cv2 (one epoch of 4
             sub-steps, `model.best` and `model-1`), and `test_generator` on
             that `model.best`;
* pretrain -- both pretraining stages at full width (reader 384x640, PWC 6
             levels r=4, batch 16, seeded random weights, synthetic scenes
             with max_mag 12), float32 (TF32 off) and bfloat16:
             `pretrain_pwc` for a warm-up and 8 timed steps (ms per step
             from CUDA events, samples/s, launches: 5 cost volume, 5 of its
             backward, 5 warp (4 in PWC, 1 in the synthesizer) and 4 of its
             backward per step, finite weights); the first step's loss and
             EPE, bfloat16 against float32; one profiled step (busy share,
             top kernels) and one step whose forward and backward kernel
             calls are held to their plain versions; one step's loss, EPE
             and gradients at batch 2, float32, card against CPU; 40 steps
             on easy scenes (max_mag 3) at batch 4 per dtype: on fresh
             scenes (the curve, and the initial net's EPE on the same
             scenes, printed) and on one fixed scene (the curve must fall); `pretrain_recover` at working 192x384, batch 16, on
             numpy frames (ms per step, 5 / 4 forward and 0 backward
             launches per step); then the chain pretrain_flow ->
             pretrain_recover -> the train CLI -> test_generator through
             each CLI's main(argv) on a cv2 JPEG tree;
* repro   -- the port of tools/repro_mosaic_dynamic_dma.py (`dynamic_copy.
             repro`), the tile copy's own path: 2 launches, bit-equal;
* profile -- device time by kernel over three of the path's forwards in
             each dtype (torch.profiler), and the device's busy share.

`--times` runs only the kernels' timing, for the package under `--root`
(default: this checkout): the cost volume's and the warp's at batch 8
(r=4), summed over one forward, and both backward kernels at the pretrain
phase's batch 16 (r=4), per level and summed over one pretraining step;
its JSON line holds them all, and ptxas' registers and spills are printed
when it builds. Given a `git archive` export of another
commit as `--root`, it times that commit's kernels with this script's
timer, so two commits compare in one call on one card.

Any failed check raises, and the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available. The line
before the last is the card's name and power limit, the one before it a
JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F


def _args() -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--times", action="store_true",
                    help="time the cost volume and the warp only")
    ap.add_argument("--root", default=None,
                    help="import the port from this tree (default: this checkout)")
    return ap.parse_args()


ARGS = _args() if __name__ == "__main__" else argparse.Namespace(times=False, root=None)
if ARGS.root:
    sys.path.insert(0, os.path.abspath(ARGS.root))

from unsupervised_detection_tpu_torch import Config  # noqa: E402
from unsupervised_detection_tpu_torch.benchlib import (  # noqa: E402
    build_forward, random_images, time_cuda)
from unsupervised_detection_tpu_torch.eval import Evaluator  # noqa: E402
from unsupervised_detection_tpu_torch.ops import _build  # noqa: E402
from unsupervised_detection_tpu_torch.ops.cost_volume import (  # noqa: E402
    cost_volume, cost_volume_backward, cost_volume_backward_plain, cost_volume_plain)
from unsupervised_detection_tpu_torch.ops.warp import (  # noqa: E402
    dense_image_warp, warp_backward, warp_backward_plain, warp_plain)

PHASES = ("card", "build", "kernels", "path", "eval", "train", "pretrain", "repro", "profile")
BATCH = 8
# PWC pyramid level -> (H, W, C) at the 384x640 reader resolution
LEVELS = {6: (6, 10, 196), 5: (12, 20, 128), 4: (24, 40, 96), 3: (48, 80, 64), 2: (96, 160, 32)}
# (B, H, W, C) off the level shapes: the 1x1 and 2x3 levels of 64x64 and
# 128x192 pyramids, batch 1, H and W off every row and pixel tile, C off the
# staging chunk (196, 36), odd C (33: 4- and 2-byte copies), C=98 (bfloat16
# 4-byte copies); for the warp C=1 and C % 8 != 0.
RAGGED_COST = ((1, 1, 1, 196), (1, 2, 3, 96), (1, 6, 10, 196), (1, 12, 20, 128),
               (1, 13, 70, 64), (3, 7, 11, 33), (2, 5, 9, 98), (1, 24, 40, 36))
RAGGED_WARP = ((1, 2, 2, 1), (1, 2, 3, 96), (1, 6, 10, 196), (3, 7, 11, 33),
               (1, 12, 20, 1), (1, 13, 70, 64), (2, 5, 9, 12))
# The backward kernels besides those: the cost volume's tiles rows, pixels
# and chunks of up to 8 channel quads, so H and W off both tiles, C one
# quad past a chunk (36), one channel past a quad (33) and under a quad
# (3); the warp's takes 4-channel quads, so C % 4 != 0 above 4 (6) and a
# quad count that is not a power of two (24: 6 quads)
RAGGED_COST_BACKWARD = RAGGED_COST + ((2, 11, 37, 36), (1, 9, 23, 3), (1, 17, 45, 33))
RAGGED_WARP_BACKWARD = RAGGED_WARP + ((2, 7, 9, 6), (1, 12, 20, 24))
TIMED_ITERS = 20
# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; float32 outside
# the tensor cores 67 TFLOP/s; bfloat16 989 TFLOP/s.
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
DTYPES = (torch.float32, torch.bfloat16)
# Tolerances, kernel vs plain version on the same card and inputs:
# * float32: both sum in float32 in other orders -> 1e-5 absolute on costs
#   of magnitude ~0.1; the warp repeats the plain arithmetic op for op and
#   is expected bit-equal (reported), held to 1e-6 relative.
# * bfloat16: both compute in float32 from the same bfloat16 inputs and round
#   once (cost volume) or per op (warp) -> at most one bfloat16 ulp of the
#   largest output, 2**-7 relative.
COST_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
WARP_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}
# Full forward, float32 card (TF32 off) vs CPU: conv sums in other orders;
# the mask is a softmax probability in [0, 1].
MASK_TOL = 1e-3
METRIC_TOL = 1e-3
# bfloat16 against float32 on the card, phase eval's dataset IoU and MAE.
# With these random weights the mask is 1 on ~78% of the frame, so the
# dataset IoU is ~0.05 and moves little: H100 readings 1.9e-5 (IoU) and
# 1.45e-3 (MAE), and 9.8e-3 / 5.8e-3 with the central crop skipped in
# bfloat16. The limits sit ~25x (IoU) and 2x (MAE) above the clean reading
# and below the skipped crop, which the phase runs as a control.
BF16_IOU_TOL = 5e-4
BF16_MAE_TOL = 3e-3
# the eval phase's input: categories x frames of raw DAVIS-sized frames
EVAL_CATEGORIES, EVAL_FRAMES, EVAL_RAW_HW = 2, 10, (480, 854)
# the train phase: full width at r=2 (the committed game arm's range);
# batch 16 is Config.batch_size's default
TRAIN_SIZES = dict(reader_height=384, reader_width=640, img_height=192, img_width=384,
                   pwc_pyr_lvls=6, pwc_search_range=2)
TRAIN_BATCH, TRAIN_PARITY_BATCH = 16, 2
# Card vs CPU, one step of each kind at batch 2, float32 with TF32 off:
# * the 8 losses within 1e-4 relative (sums over B*H*W of float32 terms;
#   cuDNN and oneDNN convolutions sum in other orders);
# * every element of the stepped net's applied gradients within 1e-4 of
#   the net's largest |gradient| (the same sums, back-propagated: their
#   rounding follows the backward pass's magnitudes, not one tensor's
#   result, which may be small). H100 readings: 1.33e-5 (generator step,
#   conv1.weight) and 3.08e-5 (recover step, flow1.weight) of the net's
#   largest, up to 2.4e-4 of a tensor's own largest (deconv5.bias);
# * the deltas, where the gradient limit fixes them. A net's first Adam
#   step moves an element by C * g / (|g| + e), e = eps / sqrt(1 - b2),
#   with C the same on both sides; for |g| > d, gradients d apart move it
#   by at most C * e * d / (|g| - d + e)**2 apart. So, with d the gradient
#   limit and k = 5% of the largest delta over C, every element with
#   |g_cpu| >= d + max(0, sqrt(e * d / k) - e) moves within 5% of the
#   tensor's largest |delta| on both; below that floor only the gradient
#   limit holds it.
TRAIN_LOSS_RTOL, TRAIN_LOSS_ATOL = 1e-4, 1e-6
TRAIN_GRAD_REL, TRAIN_DELTA_REL = 1e-4, 0.05
LOSS_KEYS = ("generator", "recover", "red_rate", "red_rate_compl", "reconstruction_loss",
             "reconstruction_compl_loss", "denominator_red_rate",
             "denominator_red_rate_compl")
# the pretrain phase: full width, PWC r=4, batch 16 (pretrain_flow.py's
# defaults); backward kernels are timed at its level shapes
PRETRAIN_SIZES = dict(reader_height=384, reader_width=640, pwc_pyr_lvls=6, pwc_search_range=4)
PRETRAIN_BATCH, PRETRAIN_PARITY_BATCH, PRETRAIN_TIMED = 16, 2, 8
LEARN_STEPS, LEARN_BATCH = 40, 4
# Backward kernels against their plain backwards on the card, each
# gradient: float32 within 1e-5 of its largest element (sums of up to 81
# products in other orders; the warp's image gradient adds up to four
# contributions per source pixel and tap with float32 atomics in no fixed
# order, n terms rounding to ~sqrt(n) * 2^-24 of their sum); bfloat16
# within 2^-7 of it (both sum in float32 and round once, and an atomic sum
# near a tie may round to the neighbouring bfloat16: one ulp, 2^-8 of the
# value).
BACKWARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
# pretrain_pwc, card vs CPU at batch 2, float32 with TF32 off: the loss and
# the EPE within 1e-4 relative, every gradient element within 1e-4 of the
# net's largest |gradient| (the train phase's limits, for its reasons).
PRETRAIN_LOSS_RTOL, PRETRAIN_GRAD_REL = 1e-4, 1e-4
# bfloat16 vs float32, the first step's loss and EPE from the same weights
# and batch: bfloat16 keeps 8 bits (~0.4% per rounding), the loss is a mean
# over ~4M per-pixel errors dominated by the targets, so roundings average
# out; fixed before the first call at 3e-2 relative.
PRETRAIN_BF16_RTOL = 3e-2
KERNEL_SOURCES = {
    "cost_volume": ("unsupervised_detection_tpu_torch/csrc/cost_volume.cu",
                    "unsupervised_detection_tpu/ops/pallas/cost_volume_kernel.py:57"),
    "warp": ("unsupervised_detection_tpu_torch/csrc/warp.cu",
             "unsupervised_detection_tpu/ops/pallas/warp_kernel.py:219"),
    "dynamic_copy": ("unsupervised_detection_tpu_torch/csrc/dynamic_copy.cu",
                     "tools/repro_mosaic_dynamic_dma.py:34"),
    # no TPU kernel: the JAX package takes these gradients in XLA
    "cost_volume_backward": ("unsupervised_detection_tpu_torch/csrc/cost_volume_backward.cu",
                             "unsupervised_detection_tpu/ops/cost_volume.py:57"),
    "warp_backward": ("unsupervised_detection_tpu_torch/csrc/warp_backward.cu",
                      "unsupervised_detection_tpu/ops/warp.py:150"),
}
BACKWARD_KERNELS = ("cost_volume_backward", "warp_backward")
# device-side kernel names (substrings of the profiler's event names)
KERNEL_SYMBOLS = {"cost_volume": "cost_volume_kernel", "warp": "warp_kernel",
                  "dynamic_copy": "dynamic_copy_kernel",
                  "cost_volume_backward": "cost_volume_backward_kernel",
                  "warp_backward": "warp_backward_kernel"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the dtype's peak; and which of the two it is."""
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cost_bound(b, h, w, c, r, dtype):
    k = (2 * r + 1) ** 2
    item = torch.empty((), dtype=dtype).element_size()
    return bound_ms((2 * b * h * w * c + b * h * w * k) * item, 2.0 * b * h * w * c * k, dtype)


def warp_bound(b, h, w, c, dtype):
    # 3 lerps of 3 operations per output element, ~10 per pixel for coordinates
    item = torch.empty((), dtype=dtype).element_size()
    return bound_ms(2 * b * h * w * c * item + b * h * w * 2 * item,
                    9.0 * b * h * w * c + 10.0 * b * h * w, dtype)


def cost_backward_bound(b, h, w, c, r, dtype):
    # reads c1, warp, out and g, writes g_c1 and g_warp; one FMA per pair
    # and gradient
    k = (2 * r + 1) ** 2
    item = torch.empty((), dtype=dtype).element_size()
    return bound_ms((4 * c + 2 * k) * b * h * w * item, 4.0 * b * h * w * c * k, dtype)


def warp_backward_bound(b, h, w, c, dtype):
    # reads image, flow and g, writes g_image and g_flow; ~20 operations per
    # element (the lerps, the two flow sums, the four weights)
    item = torch.empty((), dtype=dtype).element_size()
    return bound_ms((3 * c + 4) * b * h * w * item, 20.0 * b * h * w * c, dtype)


def clamp_flow(gen, b, h, w, dtype):
    """Flow whose sources span [-H, 2H) x [-W, 2W): taps fall inside, past
    every edge (floor and weight clamps) and at fractional positions."""
    scale = torch.tensor([h, w], dtype=torch.float32, device="cuda")
    u = torch.rand((b, h, w, 2), generator=gen, device="cuda") * 2.0 - 1.0
    return (u * scale).to(dtype)


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def check(name: str, got: torch.Tensor, want: torch.Tensor, limit: float) -> float:
    """Hold a kernel's output against its plain version; returns max abs err."""
    abs_err, rel_err = errors(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and abs_err <= limit
    log("kernels: " + json.dumps({
        "check": name, "max_abs_err": abs_err, "max_rel_err": rel_err, "tol_abs": limit,
        "bit_equal": bool(torch.equal(got, want)), "ok": ok}))
    if not ok:
        raise AssertionError(f"{name}: max abs err {abs_err} > {limit}")
    return abs_err


def tolerance(kind: str, dtype, want: torch.Tensor) -> float:
    """Absolute limit for `kind` in `dtype` (see COST_TOL / WARP_TOL)."""
    top = want.float().abs().max().item()
    if kind == "cost_volume" and dtype == torch.float32:
        return COST_TOL[dtype]
    return (COST_TOL if kind == "cost_volume" else WARP_TOL)[dtype] * top


def device_ms(fn, *args, kernel: str, iters: int = TIMED_ITERS, tries: int = 3) -> float:
    """Device ms per launch of the CUDA kernel named `kernel`: its own time on
    the card from torch.profiler over `iters` calls of fn(*args), each of
    which launches it once, after one warm-up call. The mean is over the
    launches the trace holds: a trace may drop some (seen on the H100: 0 of
    20 in a process's first trace, 19 of 20 once), so a trace with fewer
    than half of them is taken again, up to `tries` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if 2 * len(us) >= iters:
            return sum(us) / len(us) / 1e3
        seen.append(len(us))
    raise AssertionError(f"profiler saw {seen} of {iters} launches of {kernel} in {tries} traces")


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_kernels() -> dict:
    """Every kernel against its plain version; returns max abs err by kernel."""
    from unsupervised_detection_tpu_torch.ops.dynamic_copy import (
        dynamic_copy, dynamic_copy_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"cost_volume": 0.0, "warp": 0.0, "dynamic_copy": 0.0}
    level_shapes = [(f"L{lvl}", (BATCH, h, w, c)) for lvl, (h, w, c) in LEVELS.items()]
    # the train phase's levels: batch 16 at its search range only
    train_shapes = [(f"train L{lvl}", (TRAIN_BATCH, h, w, c))
                    for lvl, (h, w, c) in LEVELS.items()]
    for dtype in DTYPES:
        dn = dtype_name(dtype)
        for tag, shape in (level_shapes + train_shapes
                           + [("ragged", s) for s in RAGGED_COST]):
            c1, wp = randn(gen, shape, dtype), randn(gen, shape, dtype)
            radii = (TRAIN_SIZES["pwc_search_range"],) if tag.startswith("train") else (4, 2)
            for r in radii:
                want = cost_volume_plain(c1, wp, r)
                err["cost_volume"] = max(err["cost_volume"], check(
                    f"cost_volume {tag} r={r} {dn} {shape}", cost_volume(c1, wp, r), want,
                    tolerance("cost_volume", dtype, want)))
        for tag, shape in (level_shapes[1:] + train_shapes[1:]
                           + [("ragged", s) for s in RAGGED_WARP]):
            image = randn(gen, shape, dtype)
            flow = clamp_flow(gen, *shape[:3], dtype)
            want = warp_plain(image, flow)
            err["warp"] = max(err["warp"], check(
                f"warp {tag} {dn} {shape}", dense_image_warp(image, flow), want,
                tolerance("warp", dtype, want)))
    for axis, shape in ((1, (128, 1024)), (0, (1024, 256))):
        src = torch.rand(shape, generator=gen, device="cuda")
        offs = torch.tensor([2], dtype=torch.int32, device="cuda")
        want = dynamic_copy_plain(offs, src, axis)
        got = dynamic_copy(offs, src, axis)
        err["dynamic_copy"] = max(err["dynamic_copy"], check(
            f"dynamic_copy axis {axis} offset 2 {shape}", got, want, 0.0))
    torch.cuda.synchronize()
    return err


def check_backward(name: str, got, want, dtype) -> float:
    """Hold both gradients of a backward kernel against its plain version,
    each within BACKWARD_TOL of its largest element; returns the max abs
    err."""
    err = 0.0
    for part, g, w in zip(("first", "second"), got, want):
        limit = BACKWARD_TOL[dtype] * w.float().abs().max().item()
        err = max(err, check(f"{name} ({part} gradient)", g, w, limit))
    return err


def far_flow(gen, b, h, w, dtype):
    """Flow of 40 to 60 pixels either way on each axis: taps far from their
    pixel, beyond any window a block could keep in shared memory."""
    u = torch.rand((b, h, w, 2), generator=gen, device="cuda")
    sign = torch.where(torch.rand((b, h, w, 2), generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    return ((40.0 + 20.0 * u) * sign).to(dtype)


def check_backward_kernels() -> dict:
    """Both backward kernels against their plain backwards: the five PWC
    level shapes at the pretrain phase's batch 16, r=4 and r=2, the ragged
    shapes, clamp-driving, zero and far (40-60 px) flows for the warp's,
    float32 and bfloat16; the cost volume's at exactly zero costs (slope 1)
    and for the same bits in two calls; returns max abs err by kernel."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    err = dict.fromkeys(BACKWARD_KERNELS, 0.0)
    level_shapes = [(f"pretrain L{lvl}", (PRETRAIN_BATCH, h, w, c))
                    for lvl, (h, w, c) in LEVELS.items()]
    for dtype in DTYPES:
        dn = dtype_name(dtype)
        for tag, shape in level_shapes + [("ragged", s) for s in RAGGED_COST_BACKWARD]:
            c1, wp = randn(gen, shape, dtype), randn(gen, shape, dtype)
            for r in (4, 2):
                out = cost_volume(c1, wp, r)
                g = randn(gen, out.shape, dtype)
                first = cost_volume_backward(c1, wp, out, g, r)
                err["cost_volume_backward"] = max(err["cost_volume_backward"], check_backward(
                    f"cost_volume_backward {tag} r={r} {dn} {shape}", first,
                    cost_volume_backward_plain(c1, wp, out, g, r), dtype))
                second = cost_volume_backward(c1, wp, out, g, r)
                if not all(torch.equal(u, v) for u, v in zip(first, second)):
                    raise AssertionError(f"cost_volume_backward {tag} r={r} {dn}: two calls "
                                         "gave different bits")
        # orthogonal features: every cost exactly 0, where JAX's slope is 1
        shape = (PRETRAIN_BATCH, *LEVELS[4])
        c1, wp = randn(gen, shape, dtype), randn(gen, shape, dtype)
        half = shape[3] // 2
        c1[..., half:] = 0
        wp[..., :half] = 0
        out = cost_volume(c1, wp, 4)
        if bool(out.any()):
            raise AssertionError("cost_volume_backward zero-cost check: costs are not all 0")
        g = randn(gen, out.shape, dtype)
        err["cost_volume_backward"] = max(err["cost_volume_backward"], check_backward(
            f"cost_volume_backward zero costs r=4 {dn} {shape}",
            cost_volume_backward(c1, wp, out, g, 4),
            cost_volume_backward_plain(c1, wp, torch.ones_like(out), g, 4), dtype))
        for tag, shape in level_shapes[1:] + [("ragged", s) for s in RAGGED_WARP_BACKWARD]:
            image, g = randn(gen, shape, dtype), randn(gen, shape, dtype)
            for kind, flow in (("clamp", clamp_flow(gen, *shape[:3], dtype)),
                               ("zero", torch.zeros((*shape[:3], 2), device="cuda",
                                                    dtype=dtype)),
                               ("far", far_flow(gen, *shape[:3], dtype))):
                err["warp_backward"] = max(err["warp_backward"], check_backward(
                    f"warp_backward {tag} {kind} flow {dn} {shape}",
                    warp_backward(image, flow, g), warp_backward_plain(image, flow, g), dtype))
    torch.cuda.synchronize()
    return err


def grid_sample_args(image, flow):
    """`F.grid_sample` arguments computing the warp up to rounding (border
    padding = the TF clamps), NCHW view of the image."""
    _, h, w, _ = image.shape
    ys = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
    f = flow.float()
    grid = torch.stack([(xs - f[..., 1]) * (2.0 / (w - 1)) - 1.0,
                        (ys - f[..., 0]) * (2.0 / (h - 1)) - 1.0], dim=-1).to(image.dtype)
    return image.permute(0, 3, 1, 2), grid, "bilinear", "border", True


def time_level(name, fn, args, bound, plain=None, library=None) -> dict:
    """One kernel at one shape: CUDA-event ms, device ms, bound and share,
    plain and library ms where given."""
    ms = time_cuda(fn, *args, iters=TIMED_ITERS, repeats=5)
    dev = device_ms(fn, *args, kernel=KERNEL_SYMBOLS[name])
    row = {"ms": ms, "device_ms": dev, "bound_ms": bound[0], "bound_by": bound[1],
           "share_of_bound": bound[0] / dev}
    if plain is not None:
        row["plain_ms"] = time_cuda(plain, *args, iters=3, warmup=1, repeats=1)
    if library is not None:
        row["library_ms"] = time_cuda(library[0], *library[1], iters=TIMED_ITERS, repeats=5)
    return row


def time_kernels(with_plain: bool = True) -> dict:
    """The cost volume (r=4) and the warp at batch 8 at each level, and their
    sums over one forward's launches, per dtype: {dtype: {kernel: sums}}."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")
    totals = {}
    for dtype in DTYPES:
        dn = dtype_name(dtype)
        t = {k: dict.fromkeys(keys, 0.0) for k in ("cost_volume", "warp")}
        by = {k: {"bytes": 0.0, "operations": 0.0} for k in t}
        for lvl, (h, w, c) in LEVELS.items():
            shape = (BATCH, h, w, c)
            c1, wp = randn(gen, shape, dtype), randn(gen, shape, dtype)
            rows = {"cost_volume": time_level(
                "cost_volume", cost_volume, (c1, wp, 4), cost_bound(*shape, 4, dtype),
                plain=cost_volume_plain if with_plain else None)}
            if lvl != 6:
                flow = (torch.randn((BATCH, h, w, 2), generator=gen, device="cuda") * 2.0
                        ).to(dtype)
                gs = grid_sample_args(c1, flow)
                # same function up to rounding; reported
                lib_err = (F.grid_sample(*gs).permute(0, 2, 3, 1).float()
                           - warp_plain(c1, flow).float()).abs().max().item()
                rows["warp"] = time_level(
                    "warp", dense_image_warp, (c1, flow), warp_bound(*shape, dtype),
                    plain=warp_plain if with_plain else None, library=(F.grid_sample, gs))
                rows["warp"]["library_max_abs_diff"] = lib_err
            for name, row in rows.items():
                log("kernels: " + json.dumps({"time": f"{name} L{lvl} {dn} batch {BATCH}"
                                              + (" r=4" if name == "cost_volume" else ""),
                                              **row}))
                for k in keys:
                    t[name][k] += row.get(k, 0.0)
                by[name][row["bound_by"]] += row["bound_ms"]
        for name in t:
            t[name]["bound_by"] = max(by[name], key=by[name].get)
            t[name]["share_of_bound"] = t[name]["bound_ms"] / t[name]["device_ms"]
        t["cost_volume"]["library_ms"] = None
        totals[dn] = t
        log("kernels: " + json.dumps({"per_forward": dn, "batch": BATCH, **t}))
    return totals


def time_backward_kernels(with_plain: bool = True) -> dict:
    """Both backward kernels at the pretrain phase's level shapes (batch 16,
    r=4), and their sums over one pretrain step's launches, per dtype:
    {dtype: {kernel: sums, "levels": {level: {kernel: {device_ms, ms,
    share_of_bound}}}}}. The warp's yardstick is the backward of
    `F.grid_sample` (aten::grid_sampler_2d_backward, both gradients in one
    call): the same work, with its own coordinate and clamp rules."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")
    totals = {}
    for dtype in DTYPES:
        dn = dtype_name(dtype)
        t = {k: dict.fromkeys(keys, 0.0) for k in BACKWARD_KERNELS}
        by = {k: {"bytes": 0.0, "operations": 0.0} for k in t}
        levels = {}
        for lvl, (h, w, c) in LEVELS.items():
            shape = (PRETRAIN_BATCH, h, w, c)
            c1, wp = randn(gen, shape, dtype), randn(gen, shape, dtype)
            out = cost_volume(c1, wp, 4)
            g = randn(gen, out.shape, dtype)
            rows = {"cost_volume_backward": time_level(
                "cost_volume_backward", cost_volume_backward, (c1, wp, out, g, 4),
                cost_backward_bound(*shape, 4, dtype),
                plain=cost_volume_backward_plain if with_plain else None)}
            if lvl != 6:
                flow = (torch.randn((PRETRAIN_BATCH, h, w, 2), generator=gen, device="cuda")
                        * 2.0).to(dtype)
                gi = randn(gen, shape, dtype)
                image, grid = grid_sample_args(c1, flow)[:2]
                lib_args = (gi.permute(0, 3, 1, 2), image, grid, 0, 1, True, [True, True])
                rows["warp_backward"] = time_level(
                    "warp_backward", warp_backward, (c1, flow, gi),
                    warp_backward_bound(*shape, dtype),
                    plain=warp_backward_plain if with_plain else None,
                    library=(torch.ops.aten.grid_sampler_2d_backward, lib_args))
            levels[f"L{lvl}"] = {name: {"device_ms": row["device_ms"], "ms": row["ms"],
                                        "share_of_bound": row["share_of_bound"]}
                                 for name, row in rows.items()}
            for name, row in rows.items():
                log("kernels: " + json.dumps({"time": f"{name} L{lvl} {dn} batch "
                                              f"{PRETRAIN_BATCH}" + (" r=4" if name ==
                                                                     "cost_volume_backward"
                                                                     else ""), **row}))
                for k in keys:
                    t[name][k] += row.get(k, 0.0)
                by[name][row["bound_by"]] += row["bound_ms"]
        for name in t:
            t[name]["bound_by"] = max(by[name], key=by[name].get)
            t[name]["share_of_bound"] = t[name]["bound_ms"] / t[name]["device_ms"]
        # no single PyTorch call computes the cost volume's gradient
        t["cost_volume_backward"]["library_ms"] = None
        log("kernels: " + json.dumps({"per_pretrain_step": dn, "batch": PRETRAIN_BATCH, **t}))
        totals[dn] = {**t, "levels": levels}
    return totals


def time_copy() -> dict:
    """The tile copy at offset 2, lane case (the repro's first)."""
    from unsupervised_detection_tpu_torch.ops.dynamic_copy import (
        dynamic_copy, dynamic_copy_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    src = torch.rand((128, 1024), generator=gen, device="cuda")
    offs = torch.tensor([2], dtype=torch.int32, device="cuda")
    row = time_level("dynamic_copy", dynamic_copy, (offs, src, 1),
                     bound_ms(2 * 128 * 256 * 4, 0.0, torch.float32),
                     plain=dynamic_copy_plain)
    # no single PyTorch call takes the offset from device memory
    row["library_ms"] = None
    log("kernels: " + json.dumps({"time": "dynamic_copy axis 1 offset 2", **row}))
    return row


def phase_kernels(report: dict) -> None:
    err = check_kernels()
    err.update(check_backward_kernels())
    totals = time_kernels()
    backward = time_backward_kernels()
    copy = time_copy()
    # the JSON line: float32, summed over one forward's launches at batch 8,
    # and for the backward kernels over one pretrain step's at batch 16
    for name in ("cost_volume", "warp"):
        report[name] = {"max_abs_err": err[name], **totals["float32"][name]}
    for name in BACKWARD_KERNELS:
        report[name] = {"max_abs_err": err[name], **backward["float32"][name]}
    report["dynamic_copy"] = {"max_abs_err": err["dynamic_copy"], **copy}


def reset_counts() -> None:
    from unsupervised_detection_tpu_torch.ops.dynamic_copy import dynamic_copy

    cost_volume.launches = 0
    dense_image_warp.launches = 0
    dynamic_copy.launches = 0
    cost_volume_backward.launches = 0
    warp_backward.launches = 0



def launch_counts() -> dict:
    """Every kernel's launch count."""
    from unsupervised_detection_tpu_torch.ops.dynamic_copy import dynamic_copy

    return {"cost_volume": cost_volume.launches, "warp": dense_image_warp.launches,
            "dynamic_copy": dynamic_copy.launches,
            "cost_volume_backward": cost_volume_backward.launches,
            "warp_backward": warp_backward.launches}


def expect_counts(what: str, forwards: int = 1) -> tuple[int, int]:
    counts = (cost_volume.launches, dense_image_warp.launches)
    log(f"path: {what}: launches cost_volume={counts[0]} warp={counts[1]}")
    if counts != (5 * forwards, 4 * forwards):
        raise AssertionError(f"{what}: expected {5 * forwards} cost-volume and "
                             f"{4 * forwards} warp launches, got {counts}")
    return counts


def check_mask(what: str, mask: torch.Tensor, cfg: Config) -> None:
    shape = (cfg.batch_size, cfg.img_height, cfg.img_width, 1)
    if tuple(mask.shape) != shape:
        raise AssertionError(f"{what}: mask shape {tuple(mask.shape)} != {shape}")
    if not bool(torch.isfinite(mask).all()) or mask.min() < 0 or mask.max() > 1:
        raise AssertionError(f"{what}: mask not finite in [0, 1]")


def forward_with_sharp_head(cfg: Config, device: str):
    """build_forward with its seeded random weights, and the generator's last
    conv scaled by 100 so the mask spans [0, 1] instead of staying near 0.5:
    the thresholded metrics then see both classes."""
    fwd, obj = build_forward(cfg, device=device, seed=0)
    with torch.no_grad():
        obj.generator.conv17.weight.mul_(100.0)
    return fwd, obj


def phase_path(report: dict):
    """Returns the float32 and bfloat16 forwards and their input frames."""
    cfg = Config(batch_size=BATCH, reader_height=384, reader_width=640, img_height=192,
                 img_width=384, pwc_pyr_lvls=6, pwc_search_range=4)
    img1, img2 = random_images(cfg, seed=1, device="cuda")
    gt = torch.zeros((BATCH, cfg.reader_height, cfg.reader_width, 1), device="cuda")
    gt[:, 120:260, 200:440] = 1.0

    # the main path: Evaluator.infer_metrics, float32, counts from 0
    fwd32, obj = forward_with_sharp_head(cfg, "cuda")
    states = (obj.generator.state_dict(), obj.pwc.state_dict())
    ev = Evaluator(cfg, device="cuda")
    ev.load_state_dicts(*states)
    reset_counts()
    metrics = ev.infer_metrics(img1, img2, gt)
    torch.cuda.synchronize()
    report["launches"] = dict(zip(("cost_volume", "warp"), expect_counts("infer_metrics float32")))
    for k, v in metrics.items():
        if tuple(v.shape) != (BATCH,) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"infer_metrics {k}: {v}")
    log(f"path: infer_metrics float32 iou={metrics['iou'].tolist()} mae={metrics['mae'].tolist()}")

    reset_counts()
    mask32 = fwd32(img1, img2)
    torch.cuda.synchronize()
    expect_counts("forward float32")
    check_mask("forward float32", mask32, cfg)

    # float32 card vs CPU, one frame pair
    cpu_cfg = cfg.replace(batch_size=1)
    fwd_cpu, _ = forward_with_sharp_head(cpu_cfg, "cpu")
    mask_cpu = fwd_cpu(img1[:1].cpu(), img2[:1].cpu())
    err = (mask32[:1].cpu() - mask_cpu).abs().max().item()
    log(f"path: float32 card vs CPU mask max abs err {err} (tol {MASK_TOL})")
    if not err <= MASK_TOL:
        raise AssertionError(f"float32 card mask differs from CPU by {err} > {MASK_TOL}")
    ev_cpu = Evaluator(cpu_cfg, device="cpu")
    ev_cpu.load_state_dicts(*states)
    m_cpu = ev_cpu.infer_metrics(img1[:1].cpu(), img2[:1].cpu(), gt[:1].cpu())
    for k in ("iou", "mae"):
        d = abs(metrics[k][0].item() - m_cpu[k][0].item())
        log(f"path: float32 card vs CPU {k} abs diff {d} (tol {METRIC_TOL})")
        if not d <= METRIC_TOL:
            raise AssertionError(f"{k} card vs CPU differs by {d}")
    report["mask_err_vs_cpu"] = err

    iters, repeats = 3, 3
    timed = iters * repeats + 1     # + one warm-up forward
    reset_counts()
    ms32 = time_cuda(fwd32, img1, img2, iters=iters, warmup=1, repeats=repeats)
    expect_counts("timed forwards float32", forwards=timed)

    bcfg = cfg.replace(compute_dtype="bfloat16")
    fwd16, _ = forward_with_sharp_head(bcfg, "cuda")
    reset_counts()
    mask16 = fwd16(img1, img2)
    torch.cuda.synchronize()
    expect_counts("forward bfloat16")
    check_mask("forward bfloat16", mask16, bcfg)
    log(f"path: bfloat16 vs float32 card mask max abs diff "
        f"{(mask16 - mask32).abs().max().item()} (reported, not held)")
    reset_counts()
    ms16 = time_cuda(fwd16, img1, img2, iters=iters, warmup=1, repeats=repeats)
    expect_counts("timed forwards bfloat16", forwards=timed)
    for dn, ms in (("float32", ms32), ("bfloat16", ms16)):
        log(f"path: forward {dn} batch {BATCH}: {ms:.3f} ms, {BATCH * 1e3 / ms:.2f} frames/s "
            f"(CUDA events, median of {repeats} windows of {iters})")
    report["fps"] = {"float32": BATCH * 1e3 / ms32, "bfloat16": BATCH * 1e3 / ms16}
    return {"float32": fwd32, "bfloat16": fwd16}, (img1, img2)


def eval_batches(seed: int = 3):
    """A raw-mode `TestPipeline` over frames made in numpy, not files:
    EVAL_CATEGORIES sequences of EVAL_FRAMES uint8 frames at EVAL_RAW_HW, a
    textured square moving over a panning textured background, 0/255
    masks. The pipeline's own pairing (shift 1, the last frame pairs back),
    ordered prefetch and wrapped last batch; only the decode is replaced."""
    import numpy as np

    from unsupervised_detection_tpu_torch.data import TestPipeline
    from unsupervised_detection_tpu_torch.data.base import SequenceDataset

    rs = np.random.RandomState(seed)
    h, w = EVAL_RAW_HW
    side = 120

    def texture(shape):
        t = rs.rand(*shape).astype(np.float32)
        for axis in (0, 1):            # box blur along H and W
            t = (t + np.roll(t, 1, axis) + np.roll(t, -1, axis)) / 3.0
        return (t * 255.0).astype(np.uint8)

    arrays, names = {}, []
    for c in range(EVAL_CATEGORIES):
        bg, fg = texture((h, w, 3)), texture((side, side, 3))
        names.append([f"cat{c}/{f:05d}" for f in range(EVAL_FRAMES)])
        for f, name in enumerate(names[-1]):
            y, x = 100 + 6 * f + 20 * c, 150 + 12 * f
            img = np.roll(bg, (2 * f, 3 * f), axis=(0, 1))
            img[y:y + side, x:x + side] = fg
            mask = np.zeros((h, w, 1), np.uint8)
            mask[y:y + side, x:x + side] = 255
            arrays[name], arrays[name + ".mask"] = img, mask

    ds = SequenceDataset("DAVIS2016", [f"cat{c}" for c in range(EVAL_CATEGORIES)], names,
                         [[n + ".mask" for n in seq] for seq in names])
    return TestPipeline(ds, BATCH, 1, raw_hw=EVAL_RAW_HW, read_rgb=arrays.__getitem__,
                        read_gray=arrays.__getitem__)


def probe_imports() -> dict:
    """Whether cv2 and PIL import here: the decoders of the JPEG trees."""
    found = {}
    for name in ("cv2", "PIL"):
        try:
            found[name] = __import__(name).__version__
        except ImportError as err:
            found[name] = f"missing ({err})"
    return found


def phase_eval(report: dict) -> None:
    """evaluate_dataset on the card (float32 and bfloat16) and on the CPU,
    with the same weights and batches."""
    from unsupervised_detection_tpu_torch.eval import evaluate_dataset
    from unsupervised_detection_tpu_torch.ops.dynamic_copy import dynamic_copy

    cfg = Config(batch_size=BATCH, reader_height=384, reader_width=640, img_height=192,
                 img_width=384, pwc_pyr_lvls=6, pwc_search_range=2)
    batches = eval_batches()
    steps = batches.num_steps
    _, obj = forward_with_sharp_head(cfg, "cuda")
    states = (obj.generator.state_dict(), obj.pwc.state_dict())

    def evaluator(c, device):
        ev = Evaluator(c, device=device)
        ev.load_state_dicts(*states)
        return ev

    results = {}
    for dn in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dn)
        ev = evaluator(c, "cuda")
        reset_counts()
        res = evaluate_dataset(c, ev, batches=batches, verbose=False)
        torch.cuda.synchronize()
        counts = (cost_volume.launches, dense_image_warp.launches, dynamic_copy.launches)
        log(f"eval: {dn} card: {steps} batches, launches cost_volume={counts[0]} "
            f"warp={counts[1]} dynamic_copy={counts[2]}; frames {res['frames']} dataset IoU "
            f"{res['dataset_iou']} MAE {res['dataset_mae']} categories {res['category_iou']}")
        backward = [launch_counts()[k] for k in BACKWARD_KERNELS]
        if counts != (5 * steps, 4 * steps, 0) or backward != [0, 0]:
            raise AssertionError(f"eval {dn}: expected {5 * steps} cost-volume, {4 * steps} "
                                 f"warp, 0 tile-copy and 0 backward launches, got {counts} "
                                 f"and {backward}")
        if res["frames"] != steps * BATCH:
            raise AssertionError(f"eval {dn}: {res['frames']} frames, expected {steps * BATCH}")
        results[dn] = res
        report.setdefault("launches_eval", {})[dn] = dict(
            zip(("cost_volume", "warp", "dynamic_copy"), counts))
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            evaluate_dataset(c, ev, batches=batches, verbose=False)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        log(f"eval: evaluate_dataset {dn} on the card: {res['frames'] / walls[1]:.2f} frames/s "
            f"({res['frames']} frames in {walls[1] * 1e3:.3f} ms, median of 3; host "
            f"pipeline, feeding and bookkeeping included, no decode) [{card_line()}]")

    t0 = time.perf_counter()
    cpu = evaluate_dataset(cfg, evaluator(cfg, "cpu"), batches=batches, verbose=False)
    log(f"eval: float32 CPU: frames {cpu['frames']} dataset IoU {cpu['dataset_iou']} "
        f"MAE {cpu['dataset_mae']} ({time.perf_counter() - t0:.1f} s)")
    card = results["float32"]
    if card["frames"] != cpu["frames"] or list(card["category_iou"]) != list(cpu["category_iou"]):
        raise AssertionError(f"eval: card frames/categories {card['frames']} "
                             f"{list(card['category_iou'])} != CPU {cpu['frames']} "
                             f"{list(cpu['category_iou'])}")
    diffs = {k: float(abs(card[k] - cpu[k])) for k in ("dataset_iou", "dataset_mae")}
    for kind in ("category_iou", "category_mae"):
        for cat, v in cpu[kind].items():
            diffs[f"{kind}[{cat}]"] = abs(card[kind][cat] - v)
    log(f"eval: float32 card vs CPU abs diffs {diffs} (tol {METRIC_TOL})")
    if not all(d <= METRIC_TOL for d in diffs.values()):
        raise AssertionError(f"eval: float32 card differs from the CPU: {diffs}")

    def bf16_diffs(res: dict) -> tuple[float, float]:
        return (float(abs(res["dataset_iou"] - card["dataset_iou"])),
                float(abs(res["dataset_mae"] - card["dataset_mae"])))

    d_iou, d_mae = bf16_diffs(results["bfloat16"])
    log(f"eval: bfloat16 vs float32 card (float32 dataset IoU {card['dataset_iou']}, MAE "
        f"{card['dataset_mae']}): abs diff IoU {d_iou} (tol {BF16_IOU_TOL}), MAE {d_mae} "
        f"(tol {BF16_MAE_TOL})")
    if not (d_iou <= BF16_IOU_TOL and d_mae <= BF16_MAE_TOL):
        raise AssertionError(f"eval: bfloat16 differs from float32 by IoU {d_iou}, MAE {d_mae}")
    # control: a bfloat16 fault the limits must see (the central crop skipped)
    c = cfg.replace(compute_dtype="bfloat16", test_crop=1.0)
    f_iou, f_mae = bf16_diffs(evaluate_dataset(c, evaluator(c, "cuda"), batches=batches,
                                               verbose=False))
    log(f"eval: control, bfloat16 without the central crop vs float32 card: abs diff IoU "
        f"{f_iou}, MAE {f_mae}")
    if f_iou <= BF16_IOU_TOL and f_mae <= BF16_MAE_TOL:
        raise AssertionError("eval: the bfloat16 limits do not flag a skipped central crop")
    log(f"eval: probe {json.dumps(probe_imports())}")


def train_weights(seed: int = 0) -> dict:
    """Seeded random weights of the three nets in the flax layout (numpy),
    at full width; the generator's head x 30 so that the mask spans [0, 1]
    and its gradients do not vanish."""
    from unsupervised_detection_tpu_torch.convert import random_jax_params, random_recover_params
    from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet

    gen_p, gen_s, pwc_p = random_jax_params(
        GeneratorNet(), PWCNet(search_range=TRAIN_SIZES["pwc_search_range"]), seed)
    gen_p["conv17"]["conv"]["kernel"] = gen_p["conv17"]["conv"]["kernel"] * 30.0
    return {"gen_params": gen_p, "gen_stats": gen_s, "pwc_params": pwc_p,
            "rec_params": random_recover_params(RecoverNet(), seed + 1)}


def make_learner(cfg: Config, device: str, weights: dict):
    """An AdversarialLearner on `device` and its initial state, the nets
    loaded from `weights` through convert.py."""
    from unsupervised_detection_tpu_torch.convert import from_jax_params, recover_state_dict
    from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner

    learner = AdversarialLearner(cfg, device=device)
    learner.objective.load_state_dicts(*from_jax_params(
        weights["gen_params"], weights["gen_stats"], weights["pwc_params"]))
    learner.objective.recover.load_state_dict(recover_state_dict(weights["rec_params"]))
    return learner, learner.init_state()


def net_params(state) -> dict:
    """CPU copies of both nets' parameters: {"gen": {...}, "rec": {...}}."""
    return {net: {k: v.detach().cpu().clone() for k, v in m.named_parameters()}
            for net, m in (("gen", state.generator), ("rec", state.recover))}


def train_parity(weights: dict) -> dict:
    return hold_train_parity(*train_parity_runs(weights))


def train_parity_runs(weights: dict):
    """One generator_step and one recover_step at batch 2, float32, on the
    card and on the CPU from the same weights and draws (the state's
    generator lives on the CPU and is seeded from Config.seed on both).
    Returns ({device: [step record]}, e = eps / sqrt(1 - b2) of the Adam)."""
    cfg = Config(batch_size=TRAIN_PARITY_BATCH, **TRAIN_SIZES)
    img1, img2 = random_images(cfg, seed=5)
    runs = {}
    for device in ("cuda", "cpu"):
        learner, state = make_learner(cfg, device, weights)
        steps = []
        for name in ("generator_step", "recover_step"):
            before, counts = net_params(state), (state.gen_opt.count, state.rec_opt.count)
            t = state.shared_adam_t
            state, losses, grads = getattr(learner, name)(state, img1.to(learner.device),
                                                          img2.to(learner.device))
            net = state.generator if name == "generator_step" else state.recover
            steps.append({"name": name, "losses": {k: float(v) for k, v in losses.items()},
                          "grads": {k: g.detach().cpu() for (k, _), g in
                                    zip(net.named_parameters(), grads)},
                          "before": before, "after": net_params(state), "counts": counts,
                          "counts_after": (state.gen_opt.count, state.rec_opt.count),
                          "t": t, "t_after": state.shared_adam_t})
        runs[device] = steps
    _, _, b2, eps = learner.adam_hparams
    return runs, eps / math.sqrt(1.0 - b2)


def hold_train_parity(runs: dict, e: float) -> dict:
    """train_parity_runs' card against its CPU, to the TRAIN_* limits."""
    worst = {"loss_rel": 0.0, "grad_gap": 0.0, "grad_gap_of": None, "grad_gap_own": 0.0,
             "grad_gap_own_of": None, "delta_off": 0.0, "held_share": 1.0,
             "held_share_of": None, "not_held_off": 0}
    for card, cpu in zip(runs["cuda"], runs["cpu"]):
        name = card["name"]
        stepped, kept = ("gen", "rec") if name == "generator_step" else ("rec", "gen")
        for k in LOSS_KEYS:
            a, b = card["losses"][k], cpu["losses"][k]
            if not (math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * abs(b) + TRAIN_LOSS_ATOL):
                raise AssertionError(f"train: {name} loss {k}: card {a} CPU {b}")
            worst["loss_rel"] = max(worst["loss_rel"], abs(a - b) / max(abs(b), 1e-30))
        for run in (card, cpu):
            if not all(torch.equal(run["before"][kept][k], v)
                       for k, v in run["after"][kept].items()):
                raise AssertionError(f"train: {name} changed the {kept} net")
            i = 0 if stepped == "gen" else 1
            want = list(run["counts"])
            want[i] += 1
            if list(run["counts_after"]) != want or run["t_after"] != run["t"] + 1:
                raise AssertionError(f"train: {name} Adam counts {run['counts']} -> "
                                     f"{run['counts_after']}, shared t {run['t']} -> "
                                     f"{run['t_after']}")
        held_total = n_total = 0
        g_net = max(g.abs().max().item() for g in cpu["grads"].values())
        d = TRAIN_GRAD_REL * g_net
        for k, v in card["after"][stepped].items():
            g_card, g_cpu = card["grads"][k].flatten(), cpu["grads"][k].flatten()
            g_max = g_cpu.abs().max().item()
            gap = (g_card - g_cpu).abs().max().item()
            for key, rel in (("grad_gap", gap / g_net), ("grad_gap_own", gap / max(g_max, 1e-30))):
                if rel > worst[key]:
                    worst[key], worst[key + "_of"] = rel, f"{stepped}.{k}"
            if not gap <= d:
                raise AssertionError(f"train: {name} {stepped}.{k}: gradients differ by {gap}, "
                                     f"{gap / g_net} of the net's largest {g_net} (tol "
                                     f"{TRAIN_GRAD_REL})")
            d_card = (v - card["before"][stepped][k]).flatten()
            d_cpu = (cpu["after"][stepped][k] - cpu["before"][stepped][k]).flatten()
            scale = d_cpu.abs().max().item()
            if scale == 0.0:
                raise AssertionError(f"train: {name} {stepped}.{k} did not move")
            diff = (d_card - d_cpu).abs() / scale
            floor = d + max(0.0, math.sqrt(e * d * (g_max + e) / (TRAIN_DELTA_REL * g_max)) - e)
            held = g_cpu.abs() >= floor
            off = held & (diff > TRAIN_DELTA_REL)
            not_held_off = ~held & (diff > TRAIN_DELTA_REL)
            share = held.float().mean().item()
            held_total, n_total = held_total + int(held.sum()), n_total + held.numel()
            if share < worst["held_share"]:
                worst["held_share"], worst["held_share_of"] = share, f"{stepped}.{k}"
            if held.any():
                worst["delta_off"] = max(worst["delta_off"], diff[held].max().item())
            worst["not_held_off"] += int(not_held_off.sum())
            for i in (off | not_held_off).nonzero().flatten()[:4].tolist():
                log(f"train: {name} {stepped}.{k}[{i}] off{'' if off[i] else ' (not held)'}: "
                    f"delta card {d_card[i].item()} CPU {d_cpu[i].item()}; gradient card "
                    f"{g_card[i].item()} CPU {g_cpu[i].item()} (largest |gradient| {g_max}, "
                    f"floor {floor})")
            if off.any():
                raise AssertionError(f"train: {name} {stepped}.{k}: {int(off.sum())} deltas "
                                     f"differ by > {TRAIN_DELTA_REL:.0%} of {scale}")
        log(f"train: {name} card vs CPU, batch {TRAIN_PARITY_BATCH} float32: losses "
            f"{json.dumps(card['losses'])}; counts {card['counts']} -> {card['counts_after']}, "
            f"shared t {card['t']} -> {card['t_after']}; {kept} net bit-unchanged; deltas held "
            f"for {held_total} of {n_total} elements ({100.0 * held_total / n_total:.3f}%)")
    log(f"train: card vs CPU worst loss rel diff {worst['loss_rel']} (tol {TRAIN_LOSS_RTOL}); "
        f"worst gradient gap over the net's largest gradient {worst['grad_gap']} "
        f"({worst['grad_gap_of']}; tol {TRAIN_GRAD_REL}), over its tensor's largest "
        f"{worst['grad_gap_own']} ({worst['grad_gap_own_of']}); worst delta diff over the largest delta {worst['delta_off']} (tol "
        f"{TRAIN_DELTA_REL}) where the gradient limit fixes the delta; smallest share held "
        f"{worst['held_share']} ({worst['held_share_of']}); {worst['not_held_off']} elements "
        f"under the floor off by more")
    return worst


def profile_window(fn, iters: int):
    """(wall us, device busy us, {kernel name: [us, count]}) of `iters`
    calls of fn() under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:    # kernels and copies on the card
            acc = per_kernel.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    return wall_us, sum(us for us, _ in per_kernel.values()), per_kernel


def train_throughput(weights: dict, report: dict) -> dict:
    """2 cycles at batch 16 per dtype: launch counts, finite losses, ms per
    step, samples/s; then one profiled cycle."""
    from unsupervised_detection_tpu_torch.ops.dynamic_copy import dynamic_copy

    cfg = Config(batch_size=TRAIN_BATCH, **TRAIN_SIZES)
    img1, img2 = random_images(cfg, seed=6, device="cuda")
    out = {}
    for dn in ("float32", "bfloat16"):
        learner, state = make_learner(cfg.replace(compute_dtype=dn), "cuda", weights)
        sub_step = 0

        def one(record=None):
            nonlocal state, sub_step
            sub_step += 1
            fn = learner.select_step(sub_step)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, losses, _ = fn(state, img1, img2)
            end.record()
            if sub_step % 4 == 0:
                state = learner.incr_step(state)
            if record is not None:
                record.append((fn == learner.recover_step, start, end, losses))

        for _ in range(4):                      # warm-up cycle
            one()
        torch.cuda.synchronize()
        reset_counts()
        record: list = []
        t0 = time.perf_counter()
        for _ in range(8):
            one(record)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = (cost_volume.launches, dense_image_warp.launches, dynamic_copy.launches)
        log(f"train: {dn} batch {TRAIN_BATCH}, 8 sub-steps: launches cost_volume={counts[0]} "
            f"warp={counts[1]} dynamic_copy={counts[2]}")
        backward = [launch_counts()[k] for k in BACKWARD_KERNELS]
        if counts != (40, 32, 0) or backward != [0, 0]:
            raise AssertionError(f"train {dn}: expected 40 cost-volume, 32 warp, 0 "
                                 f"tile-copy and 0 backward launches in 8 sub-steps, got "
                                 f"{counts} and {backward}")
        if dn == "float32":
            report["launches_train"] = dict(zip(("cost_volume", "warp", "dynamic_copy"),
                                                counts))
        for is_rec, _, _, losses in record:
            bad = [k for k, v in losses.items() if not math.isfinite(float(v))]
            if bad:
                raise AssertionError(f"train {dn}: non-finite losses {bad}")
        ms = {"generator": [], "recover": []}
        for is_rec, start, end, _ in record:
            ms["recover" if is_rec else "generator"].append(start.elapsed_time(end))
        row = {"ms_generator_step": sum(ms["generator"]) / len(ms["generator"]),
               "ms_recover_step": sum(ms["recover"]) / len(ms["recover"]),
               "samples_per_s": TRAIN_BATCH * 8 * 1e3 / wall_ms,
               "last_losses": {k: float(v) for k, v in record[-1][3].items()}}
        wall_us, busy_us, per_kernel = profile_window(one, 4)
        row["busy_share"] = busy_us / wall_us
        log(f"train: {dn} batch {TRAIN_BATCH}: generator step {row['ms_generator_step']:.3f} ms, "
            f"recover step {row['ms_recover_step']:.3f} ms (CUDA events, mean of 6 / 2 after a "
            f"warm-up cycle), {row['samples_per_s']:.2f} samples/s (host clock over 8 "
            f"sub-steps), device busy {busy_us / 1e3:.3f} of {wall_us / 1e3:.3f} ms over one "
            f"profiled cycle ({100.0 * row['busy_share']:.1f}%) [{card_line()}]")
        top = sorted(((us, n, name) for name, (us, n) in per_kernel.items()), reverse=True)[:8]
        for us, n, name in top:
            log(f"train: {dn} profile {100.0 * us / busy_us:5.1f}% {us / 1e3 / 4:8.3f} "
                f"ms/sub-step {n // 4:4d}/sub-step {name[:80]}")
        row["kernel_device_ms_per_sub_step"] = {
            name: sum(us for kn, (us, _) in per_kernel.items() if KERNEL_SYMBOLS[name] in kn)
            / 1e3 / 4 for name in ("cost_volume", "warp")}
        log(f"train: {dn} kernels' device ms per sub-step "
            f"{json.dumps(row['kernel_device_ms_per_sub_step'])}")
        log(f"train: {dn} last losses {json.dumps(row['last_losses'])}")
        for name, err in check_step_kernels(one, f"train sub-step {dn}").items():
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        out[dn] = row
    return out


def check_step_kernels(step, label: str, backward: bool = False) -> dict:
    """Each kernel's wrapper against its plain version on the very inputs
    one step (`step()`) hands it, with the limits of check_kernels and
    check_backward_kernels: the recorded calls of PWC's cost volume (5) and
    warp (4) and of both backward wrappers (5 and 4 with `backward`, else
    none); returns max abs err by kernel."""
    from unsupervised_detection_tpu_torch.models import pwcnet
    from unsupervised_detection_tpu_torch.ops import cost_volume as cv_mod
    from unsupervised_detection_tpu_torch.ops import warp as warp_mod

    kernels = {"cost_volume": (pwcnet, "cost_volume", cost_volume, cost_volume_plain),
               "warp": (pwcnet, "dense_image_warp", dense_image_warp, warp_plain),
               "cost_volume_backward": (cv_mod, "cost_volume_backward", cost_volume_backward,
                                        cost_volume_backward_plain),
               "warp_backward": (warp_mod, "warp_backward", warp_backward, warp_backward_plain)}
    calls = []

    def recorder(name, fn):
        def call(*args):
            calls.append((name, [a.detach() if torch.is_tensor(a) else a for a in args]))
            return fn(*args)
        # a backward wrapper counts its launches through its module's name,
        # which now names the recorder: keep the count on it meanwhile
        call.launches = fn.launches
        return call

    recorders = {name: recorder(name, fn) for name, (_, _, fn, _) in kernels.items()}
    for name, (module, attr, _, _) in kernels.items():
        setattr(module, attr, recorders[name])
    try:
        step()
    finally:
        for name, (module, attr, fn, _) in kernels.items():
            setattr(module, attr, fn)
            if module is not pwcnet:
                fn.launches = recorders[name].launches
    names = [n for n, _ in calls]
    want = {"cost_volume": 5, "warp": 4, "cost_volume_backward": 5 * backward,
            "warp_backward": 4 * backward}
    if {n: names.count(n) for n in want} != want:
        raise AssertionError(f"{label}: recorded {names} in one step")
    err = dict.fromkeys(want, 0.0)
    for name, args in calls:
        _, _, kernel, plain = kernels[name]
        dtype = args[0].dtype
        what = f"{name} {label} {dtype_name(dtype)} {tuple(args[0].shape)}"
        with torch.no_grad():
            got, ref = kernel(*args), plain(*args)
        if name in BACKWARD_KERNELS:
            err[name] = max(err[name], check_backward(what, got, ref, dtype))
        else:
            err[name] = max(err[name], check(what, got, ref, tolerance(name, dtype, ref)))
    return err


def write_davis_tree(root: str, sequences: int = 2, frames: int = 10,
                     hw: tuple[int, int] = EVAL_RAW_HW, seed: int = 7) -> str:
    """A DAVIS2016-layout tree of JPEG frames and PNG masks written with
    cv2: a textured square moving over a panning textured background;
    sequence 0 in `train`, the others in `val`, all in `trainval`."""
    import cv2
    import numpy as np

    rs = np.random.RandomState(seed)
    h, w = hw
    side = 120
    lines: dict[str, list] = {"train": [], "val": [], "trainval": []}
    for si in range(sequences):
        seq = f"seq{si}"
        for sub in ("JPEGImages", "Annotations"):
            os.makedirs(os.path.join(root, sub, "480p", seq), exist_ok=True)
        bg = cv2.GaussianBlur(rs.randint(0, 255, (h, w, 3), dtype=np.uint8), (7, 7), 2)
        fg = cv2.GaussianBlur(rs.randint(0, 255, (side, side, 3), dtype=np.uint8), (5, 5), 1)
        for f in range(frames):
            y, x = 100 + 6 * f + 20 * si, 150 + 12 * f
            img = np.roll(bg, (2 * f, 3 * f), axis=(0, 1))
            img[y:y + side, x:x + side] = fg
            mask = np.zeros((h, w), np.uint8)
            mask[y:y + side, x:x + side] = 255
            rel_img = f"/JPEGImages/480p/{seq}/{f:05d}.jpg"
            rel_ann = f"/Annotations/480p/{seq}/{f:05d}.png"
            cv2.imwrite(root + rel_img, img)
            cv2.imwrite(root + rel_ann, mask)
            for part in ("train" if si == 0 else "val", "trainval"):
                lines[part].append(f"{rel_img} {rel_ann}")
    os.makedirs(os.path.join(root, "ImageSets", "480p"), exist_ok=True)
    for part, ls in lines.items():
        with open(os.path.join(root, "ImageSets", "480p", part + ".txt"), "w") as fh:
            fh.write("\n".join(ls) + "\n")
    return root


def run_captured(fn, *args, **kw):
    """fn's result and what it printed (echoed to the log)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kw)
    for line in buf.getvalue().splitlines():
        if not line.startswith((" ", "{")):     # skip the pretty-printed config
            log("train: cli: " + line)
    return result, buf.getvalue()


def train_cli(report: dict) -> None:
    """The train CLI through main(argv) on a JPEG tree, on the card, then
    test_generator on its model.best."""
    import importlib
    import tempfile

    from unsupervised_detection_tpu_torch import test_generator
    from unsupervised_detection_tpu_torch.ops.dynamic_copy import dynamic_copy

    cli = importlib.import_module("unsupervised_detection_tpu_torch.train.__main__")
    with tempfile.TemporaryDirectory() as tmp:
        root = write_davis_tree(os.path.join(tmp, "davis"))
        ckpt_dir = os.path.join(tmp, "ckpt")
        # 2 sequences x 10 frames: 32 training pairs (2 batches of 16 per
        # permutation); an epoch of 4 batches is 4 sub-steps (gen, gen, gen,
        # rec); the val partition (sequence 1) is one wrapped batch
        flags = [f"--root_dir={root}", "--pwc_search_range=2",
                 f"--batch_size={TRAIN_BATCH}", "--num_threads=4"]
        val_batches = -(-10 // TRAIN_BATCH)
        batches = 4 + val_batches
        reset_counts()
        t0 = time.perf_counter()
        state, text = run_captured(cli.main, flags + [
            f"--checkpoint_dir={ckpt_dir}", "--allow_random_flow",
            f"--num_samples_train={4 * TRAIN_BATCH}", "--max_epochs=1", "--summary_freq=1",
            "--save_freq=1"])
        counts = (cost_volume.launches, dense_image_warp.launches, dynamic_copy.launches)
        saved = sorted(os.listdir(ckpt_dir))
        log(f"train: cli: {time.perf_counter() - t0:.2f} s, saves {saved}, launches "
            f"cost_volume={counts[0]} warp={counts[1]} dynamic_copy={counts[2]}, Adam counts "
            f"{state.gen_opt.count}/{state.rec_opt.count}")
        if ("Training completed successfully" not in text or saved != ["model-1", "model.best"]
                or (state.gen_opt.count, state.rec_opt.count) != (3, 1)):
            raise AssertionError(f"train CLI: saves {saved}, output ends {text[-300:]!r}")
        if counts != (5 * batches, 4 * batches, 0):
            raise AssertionError(f"train CLI: launches {counts} in {batches} batches")
        res, text = run_captured(test_generator.main, flags + [
            f"--ckpt_file={os.path.join(ckpt_dir, 'model.best')}"])
        if "The Average over the dataset: IoU is" not in text or res["frames"] != TRAIN_BATCH * val_batches:
            raise AssertionError(f"test_generator on model.best: {text[-300:]!r}")
    report["train_cli"] = {"saves": saved, "dataset_iou": res["dataset_iou"]}


def phase_train(report: dict) -> None:
    weights = train_weights()
    t0 = time.perf_counter()
    report["train_parity"] = train_parity(weights)
    log(f"train: parity {time.perf_counter() - t0:.1f} s")
    report["train"] = train_throughput(weights, report)
    train_cli(report)


def pretrain_weights(seed: int = 10) -> dict:
    """Seeded random PWC weights at r=4 (flax he-normal / glorot layout,
    numpy), as a PWCNet state dict."""
    from unsupervised_detection_tpu_torch.convert import pwc_state_dict, random_jax_params
    from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet

    _, _, pwc_p = random_jax_params(
        GeneratorNet(), PWCNet(search_range=PRETRAIN_SIZES["pwc_search_range"]), seed)
    return pwc_state_dict(pwc_p)


def all_finite(net) -> bool:
    return all(bool(torch.isfinite(p).all()) for p in net.parameters())


def pretrain_run(cfg: Config, weights: dict, dn: str) -> dict:
    """`pretrain_pwc` itself for 1 + PRETRAIN_TIMED steps at batch 16, full
    width, on synthetic scenes (max_mag 12): the batch hook records a CUDA
    event as each step begins, so step i's ms is event i+1 - event i; counts
    from 0 just before, read just after; samples/s on the host clock over
    the timed steps."""
    from unsupervised_detection_tpu_torch.train.pretrain_pwc import (pretrain_pwc,
                                                                     synthetic_flow_batch)

    events, starts = [], []

    def timed_batches(rng, batch, h, w):
        if len(events) == 1:
            torch.cuda.synchronize()                   # the warm-up step is done
        starts.append(time.perf_counter())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return synthetic_flow_batch(rng, batch, h, w, max_mag=12.0, device="cuda")

    steps = 1 + PRETRAIN_TIMED
    reset_counts()
    net, epe = pretrain_pwc(cfg.replace(compute_dtype=dn), steps, verbose=False,
                            batch_fn=timed_batches, params=weights, device="cuda")
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - starts[1]
    counts = launch_counts()
    want = {"cost_volume": 5 * steps, "warp": 5 * steps, "dynamic_copy": 0,
            "cost_volume_backward": 5 * steps, "warp_backward": 4 * steps}
    log(f"pretrain: {dn} pretrain_pwc {steps} steps batch {PRETRAIN_BATCH}: launches "
        f"{json.dumps(counts)} (expected {json.dumps(want)})")
    if counts != want:
        raise AssertionError(f"pretrain {dn}: launches {counts}, expected {want}")
    if not (math.isfinite(epe) and all_finite(net)):
        raise AssertionError(f"pretrain {dn}: final EPE {epe} or weights not finite")
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events[1:-1], events[2:])]
    row = {"ms_per_step": sum(step_ms) / len(step_ms), "ms_per_step_min": min(step_ms),
           "samples_per_s": PRETRAIN_BATCH * PRETRAIN_TIMED / wall, "final_epe": epe,
           "launches": counts}
    log(f"pretrain: {dn} batch {PRETRAIN_BATCH}: {row['ms_per_step']:.3f} ms per step "
        f"(CUDA events, mean of {PRETRAIN_TIMED} after a warm-up step; min "
        f"{row['ms_per_step_min']:.3f}), {row['samples_per_s']:.2f} samples/s (host clock), "
        f"final EPE {epe:.4f} px [{card_line()}]")
    return row


def pretrain_trainer(cfg: Config, weights: dict, dn: str, device: str = "cuda", steps=1):
    from unsupervised_detection_tpu_torch.train.pretrain_pwc import PWCPretrainer

    return PWCPretrainer(cfg.replace(compute_dtype=dn), steps, params=weights, device=device)


def scene(batch: int, seed: int, device: str = "cuda", max_mag: float = 12.0):
    import numpy as np

    from unsupervised_detection_tpu_torch.train.pretrain_pwc import synthetic_flow_batch

    return synthetic_flow_batch(np.random.RandomState(seed), batch,
                                PRETRAIN_SIZES["reader_height"],
                                PRETRAIN_SIZES["reader_width"], max_mag=max_mag, device=device)


def pretrain_profile_and_check(cfg: Config, weights: dict, dn: str, report: dict) -> dict:
    """The first step's loss and EPE (no update) from the weights on seed
    20's batch; then one profiled step (busy share, top kernels) and one
    step whose kernel calls are held to their plain versions."""
    trainer = pretrain_trainer(cfg, weights, dn)
    batch = scene(PRETRAIN_BATCH, seed=20)
    loss, epe, _, _ = trainer.loss_and_grads(*batch)
    first = {"loss": float(loss), "epe": float(epe)}
    trainer.step(*batch)                               # warm
    torch.cuda.synchronize()
    wall_us, busy_us, per_kernel = profile_window(lambda: trainer.step(*batch), 1)
    log(f"pretrain: {dn} profiled step: device busy {busy_us / 1e3:.3f} of "
        f"{wall_us / 1e3:.3f} ms ({100.0 * busy_us / wall_us:.1f}%)")
    for us, n, name in sorted(((us, n, k) for k, (us, n) in per_kernel.items()),
                              reverse=True)[:8]:
        log(f"pretrain: {dn} profile {100.0 * us / busy_us:5.1f}% {us / 1e3:8.3f} ms {n:4d}x "
            f"{name[:80]}")
    kernel_ms = {name: sum(us for kn, (us, _) in per_kernel.items() if KERNEL_SYMBOLS[name] in kn)
                 / 1e3 for name in ("cost_volume", "warp") + BACKWARD_KERNELS}
    log(f"pretrain: {dn} kernels' device ms in the profiled step {json.dumps(kernel_ms)}")
    for name, err in check_step_kernels(lambda: trainer.step(*batch), f"pretrain step {dn}",
                                        backward=True).items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    return {"first": first, "busy_share": busy_us / wall_us, "kernel_device_ms": kernel_ms}


def pretrain_parity(cfg: Config, weights: dict) -> dict:
    """One pretrain_pwc step's loss, EPE and gradients at batch 2, float32,
    card against CPU from the same weights and batch."""
    batch = scene(PRETRAIN_PARITY_BATCH, seed=21, device="cpu")
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = pretrain_trainer(cfg, weights, "float32", device)
        loss, epe, _, grads = trainer.loss_and_grads(*(t.to(device) for t in batch))
        names = [k for k, _ in trainer.net.named_parameters()]
        runs[device] = (float(loss), float(epe), {k: g.cpu() for k, g in zip(names, grads)})
    (l_c, e_c, g_c), (l_p, e_p, g_p) = runs["cuda"], runs["cpu"]
    g_net = max(g.abs().max().item() for g in g_p.values())
    gaps = {k: (g_c[k] - g_p[k]).abs().max().item() for k in g_p}
    worst = max(gaps, key=gaps.get)
    own = max(gaps, key=lambda k: gaps[k] / max(g_p[k].abs().max().item(), 1e-30))
    out = {"loss_rel": abs(l_c - l_p) / abs(l_p), "epe_rel": abs(e_c - e_p) / abs(e_p),
           "grad_gap": gaps[worst] / g_net, "grad_gap_of": worst,
           "grad_gap_own": gaps[own] / max(g_p[own].abs().max().item(), 1e-30),
           "grad_gap_own_of": own}
    log(f"pretrain: card vs CPU, batch {PRETRAIN_PARITY_BATCH} float32: loss {l_c} / {l_p}, "
        f"EPE {e_c} / {e_p}; {json.dumps(out)} (tol loss/EPE {PRETRAIN_LOSS_RTOL} relative, "
        f"gradients {PRETRAIN_GRAD_REL} of the net's largest {g_net})")
    if not (out["loss_rel"] <= PRETRAIN_LOSS_RTOL and out["epe_rel"] <= PRETRAIN_LOSS_RTOL
            and out["grad_gap"] <= PRETRAIN_GRAD_REL):
        raise AssertionError(f"pretrain: card differs from the CPU: {out}")
    return out


def pretrain_learning(cfg: Config, weights: dict, dn: str) -> dict:
    """LEARN_STEPS pretrain steps at batch 4 on easy scenes (max_mag 3),
    twice from the same weights:

    * fresh scenes at every step: the EPE curve, and beside it the initial
      net's EPE on the same scenes (each scene's own flow magnitude sets
      most of its EPE, so the curve alone swings with the draw), printed;
    * one fixed scene at every step: the EPE curve, whose last 5 steps'
      mean must be under the first step's (held).
    """
    import numpy as np

    from unsupervised_detection_tpu_torch.train.pretrain_pwc import pwc_loss, synthetic_flow_batch

    def easy(rng):
        return synthetic_flow_batch(rng, LEARN_BATCH, cfg.reader_height, cfg.reader_width,
                                    max_mag=3.0, device="cuda")

    lcfg = cfg.replace(batch_size=LEARN_BATCH)
    fixed_net = pretrain_trainer(lcfg, weights, dn).net
    trainer = pretrain_trainer(lcfg, weights, dn, steps=LEARN_STEPS)
    rng = np.random.RandomState(30)
    fresh, initial = [], []
    for _ in range(LEARN_STEPS):
        batch = easy(rng)
        with torch.no_grad():
            initial.append(float(pwc_loss(fixed_net, *batch)[1]))
        fresh.append(float(trainer.step(*batch)[1]))
    trainer = pretrain_trainer(lcfg, weights, dn, steps=LEARN_STEPS)
    batch = easy(np.random.RandomState(31))
    fixed = [float(trainer.step(*batch)[1]) for _ in range(LEARN_STEPS)]
    out = {"fresh": fresh, "fresh_initial_net": initial, "fixed": fixed}
    for name, curve in out.items():
        log(f"pretrain: {dn} learning, batch {LEARN_BATCH}, max_mag 3, {name}: EPE "
            f"{' '.join(f'{e:.4f}' for e in curve)}")
    last5 = {k: sum(v[-5:]) / 5 for k, v in out.items()}
    log(f"pretrain: {dn} learning: last 5 mean / first: fresh {last5['fresh'] / fresh[0]:.4f}; "
        f"fresh against the initial net on the same scenes {last5['fresh'] / last5['fresh_initial_net']:.4f}; "
        f"fixed {last5['fixed'] / fixed[0]:.4f} (held: < 1)")
    if not (all(math.isfinite(e) for e in fixed + fresh) and last5["fixed"] < fixed[0]):
        raise AssertionError(f"pretrain {dn}: EPE on a fixed scene did not fall: {fixed}")
    return out


def recover_frames(batches: int, seed: int = 40):
    """Host-mode batches of float32 frame pairs at the reader resolution,
    made in numpy: a textured square moving over a panning textured
    background, as the pipeline hands them to DeviceFeeder."""
    import numpy as np

    rs = np.random.RandomState(seed)
    h, w = PRETRAIN_SIZES["reader_height"], PRETRAIN_SIZES["reader_width"]
    side = min(h, w) // 4
    bg = rs.rand(PRETRAIN_BATCH, h + 16, w + 16, 3).astype(np.float32) - 0.5
    fg = rs.rand(PRETRAIN_BATCH, side, side, 3).astype(np.float32) - 0.5
    for i in range(batches):
        pair = []
        for t in (i, i + 1):
            img = bg[:, 2 * t % 16:2 * t % 16 + h, 3 * t % 16:3 * t % 16 + w].copy()
            y, x = h // 4 + 2 * t, w // 3 + 3 * t
            img[:, y:y + side, x:x + side] = fg
            pair.append(img)
        yield {"img1": pair[0], "img2": pair[1]}


def pretrain_recover_run(dn: str, steps: int = 4) -> dict:
    """pretrain_recover at reader 384x640 / working 192x384, batch 16, on
    numpy frames: ms per step (CUDA events recorded as each batch is
    drawn, the first step a warm-up) and launches (5 / 4 forward, 0
    backward per step)."""
    from unsupervised_detection_tpu_torch.train.pretrain import pretrain_recover

    cfg = Config(batch_size=PRETRAIN_BATCH, img_height=192, img_width=384, **PRETRAIN_SIZES,
                 compute_dtype=dn, allow_random_flow=True)
    events = []

    def batches():
        for b in recover_frames(steps):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            yield b

    reset_counts()
    net = pretrain_recover(cfg, steps, verbose=False, device="cuda", batches=batches())
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {"cost_volume": 5 * steps, "warp": 4 * steps, "dynamic_copy": 0,
            "cost_volume_backward": 0, "warp_backward": 0}
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events[1:-1], events[2:])]
    row = {"ms_per_step": sum(step_ms) / len(step_ms), "launches": counts}
    log(f"pretrain: recover {dn} batch {PRETRAIN_BATCH}, {steps} steps: "
        f"{row['ms_per_step']:.3f} ms per step (CUDA events, mean of {steps - 1} after a "
        f"warm-up step), launches {json.dumps(counts)} [{card_line()}]")
    if counts != want or not all_finite(net):
        raise AssertionError(f"pretrain_recover {dn}: launches {counts} (expected {want}) "
                             "or weights not finite")
    return row


def pretrain_chain(report: dict) -> None:
    """pretrain_flow (2 steps) -> pretrain_recover (2 steps, --flow_ckpt) ->
    the train CLI (--flow_ckpt, --recover_ckpt, one epoch) -> test_generator,
    through each CLI's main(argv), on a JPEG tree written with cv2."""
    import importlib
    import tempfile

    from unsupervised_detection_tpu_torch import pretrain_flow, pretrain_recover, test_generator

    train_main = importlib.import_module("unsupervised_detection_tpu_torch.train.__main__").main
    with tempfile.TemporaryDirectory() as tmp:
        root = write_davis_tree(os.path.join(tmp, "davis"))
        dirs = {k: os.path.join(tmp, k) for k in ("pwc", "rec", "game")}
        common = [f"--batch_size={PRETRAIN_BATCH}", "--num_threads=4"]
        t0 = time.perf_counter()
        reset_counts()
        run_captured(pretrain_flow.main, common + [f"--checkpoint_dir={dirs['pwc']}",
                                                   "--pretrain_steps=2"])
        flow_counts = launch_counts()
        flow_ckpt = os.path.join(dirs["pwc"], "pwc-final")
        run_captured(pretrain_recover.main, common + [
            f"--root_dir={root}", f"--flow_ckpt={flow_ckpt}", f"--checkpoint_dir={dirs['rec']}",
            "--pretrain_steps=2"])
        rec_ckpt = os.path.join(dirs["rec"], "recover-final")
        state, text = run_captured(train_main, common + [
            f"--root_dir={root}", f"--checkpoint_dir={dirs['game']}", f"--flow_ckpt={flow_ckpt}",
            f"--recover_ckpt={rec_ckpt}", f"--num_samples_train={4 * PRETRAIN_BATCH}",
            "--max_epochs=1", "--summary_freq=1", "--save_freq=1"])
        if ("Flow net loaded from" not in text or "Recover net loaded from previous ckpt"
                not in text or "Training completed successfully" not in text):
            raise AssertionError(f"pretrain chain: train CLI output ends {text[-300:]!r}")
        res, text = run_captured(test_generator.main, common + [
            f"--root_dir={root}", f"--ckpt_file={os.path.join(dirs['game'], 'model.best')}"])
        saves = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
        log(f"pretrain: chain {time.perf_counter() - t0:.2f} s, saves {saves}, pretrain_flow "
            f"launches {json.dumps(flow_counts)}, dataset IoU {res['dataset_iou']}")
        if (saves != {"pwc": ["pwc-final"], "rec": ["recover-final"],
                      "game": ["model-1", "model.best"]}
                or flow_counts["cost_volume_backward"] != 10
                or "The Average over the dataset: IoU is" not in text):
            raise AssertionError(f"pretrain chain: saves {saves}, counts {flow_counts}")
    report["pretrain_chain"] = {"saves": saves, "dataset_iou": res["dataset_iou"]}


def phase_pretrain(report: dict) -> None:
    weights = pretrain_weights()
    cfg = Config(batch_size=PRETRAIN_BATCH, **PRETRAIN_SIZES)
    out = {}
    for dn in ("float32", "bfloat16"):
        row = pretrain_run(cfg, weights, dn)
        row.update(pretrain_profile_and_check(cfg, weights, dn, report))
        out[dn] = row
    report["launches_pretrain"] = out["float32"]["launches"]
    f32, b16 = out["float32"]["first"], out["bfloat16"]["first"]
    rel = {k: abs(b16[k] - f32[k]) / abs(f32[k]) for k in ("loss", "epe")}
    log(f"pretrain: first step bfloat16 vs float32: {json.dumps(b16)} vs {json.dumps(f32)}, "
        f"relative {json.dumps(rel)} (tol {PRETRAIN_BF16_RTOL})")
    if not all(v <= PRETRAIN_BF16_RTOL for v in rel.values()):
        raise AssertionError(f"pretrain: bfloat16 first step differs from float32: {rel}")
    t0 = time.perf_counter()
    out["parity"] = pretrain_parity(cfg, weights)
    log(f"pretrain: parity {time.perf_counter() - t0:.1f} s")
    for dn in ("float32", "bfloat16"):
        out[dn]["learning"] = pretrain_learning(cfg, weights, dn)
        out[dn]["recover"] = pretrain_recover_run(dn)
    pretrain_chain(report)
    report["pretrain"] = out


def phase_profile(forwards: dict, images, iters: int = 3, top: int = 12) -> None:
    """Device time by kernel over `iters` of the path's forwards at batch 8
    (torch.profiler), and the device's busy share of the profiled window."""
    img1, img2 = images
    for dtype, fwd in forwards.items():
        wall_us, busy, per_kernel = profile_window(lambda: fwd(img1, img2), iters)
        rows = sorted(((us, n, name) for name, (us, n) in per_kernel.items()), reverse=True)
        log(f"profile: {dtype} batch {BATCH}: {iters} forwards, wall {wall_us / 1e3:.3f} ms, "
            f"device busy {busy / 1e3:.3f} ms ({100.0 * busy / wall_us:.1f}% of the window)")
        for us, count, name in rows[:top]:
            log(f"profile: {dtype} {100.0 * us / busy:5.1f}% {us / 1e3 / iters:8.3f} ms/fwd "
                f"{count // iters:4d}/fwd {name[:90]}")


def phase_repro(report: dict) -> None:
    """The tile copy's own path: the port of the Mosaic repro's main."""
    from unsupervised_detection_tpu_torch.ops.dynamic_copy import dynamic_copy, repro

    reset_counts()
    result = repro()
    torch.cuda.synchronize()
    launches = dynamic_copy.launches
    log(f"repro: {result}, launches dynamic_copy={launches}")
    if launches != 2 or not all(result.values()):
        raise AssertionError(f"repro: {result} with {launches} launches (expected 2, all equal)")
    report["launches"]["dynamic_copy"] = launches


def log_build() -> None:
    """Build the kernels (or load them) and print ptxas' resource usage."""
    lib = _build.library()
    log(f"build: nvcc {lib.build_seconds:.2f} s -> {lib.path}")
    for line in lib.log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            log("build: " + line.strip())


def main_times() -> int:
    """Kernel times only, for the package under --root: the forward kernels
    summed over one forward, the backward kernels per level and summed over
    one pretraining step."""
    log(f"card: {card_line()}")
    log_build()
    totals = time_kernels(with_plain=False)
    backward = time_backward_kernels(with_plain=False)

    def sums(t):
        return {k: {"device_ms": v["device_ms"], "ms": v["ms"]}
                for k, v in t.items() if k != "levels"}

    print(json.dumps({"times": {dn: sums(t) for dn, t in totals.items()},
                      "backward": {dn: {**sums(t), "levels": t["levels"]}
                                   for dn, t in backward.items()},
                      "root": os.path.abspath(ARGS.root or os.path.dirname(__file__))}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if ARGS.times:
        return main_times()

    t_run = time.perf_counter()
    report: dict = {}
    for phase in PHASES:
        t0 = time.perf_counter()
        if phase == "card":
            log(f"card: {card_line()}")
        elif phase == "build":
            log_build()
        elif phase == "kernels":
            phase_kernels(report)
        elif phase == "path":
            forwards, images = phase_path(report)
        elif phase == "eval":
            phase_eval(report)
        elif phase == "train":
            phase_train(report)
        elif phase == "pretrain":
            phase_pretrain(report)
        elif phase == "repro":
            phase_repro(report)
        else:
            phase_profile(forwards, images)
        log(f"phase {phase}: {time.perf_counter() - t0:.2f} s")
    log(f"total: {time.perf_counter() - t_run:.2f} s")

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        k = report[name]
        backward = name in BACKWARD_KERNELS
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # a backward kernel's main path is pretraining: PWC is frozen in
            # the forward, eval and train paths, which launch it 0 times
            "launches": report["launches_pretrain" if backward else "launches"][name],
            "launches_eval": 0 if backward else report["launches_eval"]["float32"][name],
            "launches_train": 0 if backward else report["launches_train"][name],
            "launches_pretrain": report["launches_pretrain"][name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "share_of_bound": k["share_of_bound"], "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
