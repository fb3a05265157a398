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
             against the same forward on the CPU for one frame pair,
             frames/s from CUDA events, and the forward's time under
             cuDNN's deterministic algorithms against the default, in
             turns, per dtype;
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
* postproc -- the post-processed evaluation path at full width (PWC r=2,
             recover f=0.25, the eval phase's weights and batches): the
             4-crop `EnsembleEvaluator` at batch 8 (4B = 32 frames through
             PWC) in float32 and bfloat16 (5 cost-volume and 4 warp
             launches per batch, no backward or tile-copy launch, frames/s,
             the busy share of one batch, each kernel against its plain
             version on one batch's own inputs), the crop-1.0 member
             against `Evaluator.infer`, card against CPU at B=1, bfloat16
             against float32 on the 4-crop-mean dataset IoU and MAE; the
             dense `evaluate_dataset` (one PNG and one .mat per frame, its
             host metrics against the device's on the same masks and
             against a second forward); the CLI chain on a cv2 JPEG tree of
             2 x 6 frames at 480x854: `test_generator_ensemble` for the
             shifts -2, -1, 1, 2 on a training save, then `post_processing`
             with the PWC backend on the card and the native CRF (seconds
             per frame of the soft score, the propagation and the CRF, the
             resized CRF IoU); `pwc_flow_fn` on one 192x384 pair, card
             against CPU, its launches and kernels, ms per pair;
* tf1     -- the reference's TF1 checkpoints without TensorFlow, full width
             (generator cnum 32, recover f=0.25, PWC 6 levels), seeded random
             weights: `export_tf1_checkpoint` at r=4 and r=2, read back with
             `read_bundle`, every tensor bit-equal (bytes, write and read
             seconds, crc32c included); `test_generator` on a cv2 JPEG tree
             of 2 x 10 frames at 480x854 (reader 384x640, r=4, batch 8, 3
             batches) from the r=4 bundle and from the `.npz` of the same
             weights in float32 (TF32 off) and bfloat16: the restored state
             dicts bit-equal, every IoU/MAE within METRIC_TOL, 5 + 4
             launches per batch; an r=2 bundle at r=4 refused, naming both
             ranges; `pwc_flow_fn` from the r=4 bundle against a scope save
             of the same PWC on one 192x384 pair; the train CLI (float32,
             r=2, batch 16, 8 sub-steps, `--summary_freq=2`) with
             `--flow_ckpt` and `--recover_ckpt` the r=2 bundle, without the
             TensorBoard writer, with it and without it again (launches per
             sub-step, summary and validation batch; samples/s, wall and the
             seconds in the summaries; the event file's scalar, histogram
             and image tags). Where tensorboardX does not import, the
             driver's writer is None, as in the JAX package, and PyTorch's
             `torch.utils.tensorboard.SummaryWriter` stands in for the
             writer run;
* jmean   -- the flagship's trained weights end to end: the committed
             export weights_torch/flagship_v2lr_r2.npz (its sha256
             printed; generator cnum 32, PWC 6 levels r=2) through
             `e2e_jmean.main` on the 5 x 24 frames it renders at 192x384:
             `test_generator` in float32 and bfloat16 (batch 8), the
             ensemble CLI for the shifts -2, -1, 1, 2 at batch 1 writing
             its buffers, `post_processing` with the PWC backend on the card
             and the native CRF at the working and the original resolution,
             the report; launches per stage (5 cost-volume and 4 warp per
             raw batch, ensemble frame and propagated pair, no backward or
             tile-copy launch); the raw float32 IoU of the dataset and of
             each sequence, the soft score, the propagated average and both
             CRF IoUs against experiments/e2e_jmean/REPORT.md; bfloat16
             against float32 on the raw and the shift +1 ensemble's dataset
             IoU and MAE, each with a control the limits must flag (the
             central crop skipped; every member at crop 1.0); each kernel
             against its plain version on one raw batch's inputs in both
             dtypes; each stage's seconds and seconds per frame; the post
             stages against the JAX chain's run with the same PWC backend
             on a CPU (weights_torch/jmean_pwc_backend_jax_cpu.md);
             `scan_propagate` on the first sequence's soft-score masks and
             PWC flows (T = 24) at 192x384 and 480x854: card against CPU,
             against the host loop on 1/32-px flows, 2(T-1) warp launches,
             ms per call and the warp's device us per launch at C = 1;
             `trace` of one flagship forward, whose file names the cost
             volume's and the warp's kernels, and `sync`;
* recipe  -- the recipe that made the flagship (`recipe/`) at full size with
             the flagship's PWC (r=2), float32 with TF32 off and bfloat16:
             the three scene generators (the game's at 192x384 batch 16,
             v2 and v3 at 128x192 batch 8) drawn on the host and rendered
             on the card and on the CPU (images and flows within 1e-6,
             masks equal, one warp launch, the warp kernel bit-equal to
             warp_plain on the render's inputs); the region-EPE
             diagnostic's three paths at batch 16, card against CPU within
             1e-3 px and beside JAX's record within a band from the CPU's
             spread over seeds; the game (100 warm-start steps, 50 cycles
             per dtype at batch 16, square 48, f=0.25, cuDNN deterministic):
             seconds per cycle, 5 cost-volume and 5 warp launches per
             sub-step, the first sub-step's 8 losses against the CPU within
             1e-4, model-25 resumed to cycle 50 bit-equal to the
             uninterrupted run, `model.best` read by the evaluation loader,
             the kernels on one sub-step's inputs; 30 steps of PWC recipe
             v2 per dtype (128x192, batch 8, cosine, object weight 4): ms
             per step, 5 / 5 / 5 / 4 forward and backward launches per
             step, a held-out EPE that must fall, the kernels on one step;
* gametools -- the game's instruments (`recipe/synth.py`, `inspect_mask.py`,
             `game_stats.py`): the synthetic game through its CLI's `main`
             at the tool's batch 8 and 200 warm-start steps, 100 of its 400
             cycles (64x128, fp32, f=0.25, no PWC): its console lines
             against the committed full run's, s per cycle, the final IoU,
             no kernel launch, the first sub-step's 8 losses card against
             CPU within 1e-4, `game_stats` on its log;
             the mask inspector at 192x384, batch 16, on the flagship and on
             the port's own detector (weights_torch/), each with the
             flagship's PWC at r=2: its table, card against CPU (IoU, area
             and in-gt within 1e-3, the centroid within 0.1 px, the
             components equal), 1 warp launch in the render and 5
             cost-volume and 4 warp in the PWC forward per inspection, s per
             inspection, the kernels on its inputs; `game_stats` on the
             port's two game logs and the JAX arms' four; the layer
             tapes: every layer of the inspector's flagship forward
             (pyramid, cost volumes, estimators, context nets, warps,
             upsamplings, resize_to_working, the flow's standardization,
             the generator's layers) card against CPU in float32, with
             and without cuDNN's deterministic algorithms, the first layer
             past LAYER_TOL and its float64 arbiter, and one run on 8
             pairs of the J-mean chain's JPEG video;
* train   -- the two-player training game at full width (reader 384x640,
             working 192x384, PWC 6 levels r=2, generator cnum 32, recover
             f=0.25) with seeded random weights: one `generator_step` and one
             `recover_step` at batch 2 in float32 (TF32 off) on the card and
             on the CPU from the same weights and augmentation draws (the 8
             losses, the stepped net's gradients and, where those fix them,
             its deltas within the stated limits, with the share of elements
             whose deltas are held; the other net and its Adam count
             unchanged, the shared Adam step advanced); one generator_step
             and one recover_step at batch 16 in bfloat16 against float32
             from the same weights and draws (the losses and the
             gradient's relative L2 error), and the next draw in both
             dtypes (the control, printed); 2 cycles (8
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
             EPE, bfloat16 against float32, and bfloat16 on another scene
             as the control that must break that limit; one profiled step (busy share,
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
* mesh    -- the device mesh (parallel/mesh.py) at full width (reader
             384x640, working 192x384, PWC 6 levels r=2, generator cnum 32,
             recover f=0.25), seeded random weights, float32 with TF32 off
             and cuDNN's deterministic algorithms (without them two float32
             forwards on the card differ in the last bits), each rank
             joining its group through `mesh_from_env` from torchrun's
             variables. World 1 under
             NCCL, the main path of the phase, its launches counted: 2
             learner sub-steps at batch 16, `evaluate_dataset` on the eval
             phase's 3 batches, one ensemble batch and one recover
             pretraining step at batch 8, each bit-equal to the same calls
             with no process group. Then 2 spawned ranks sharing the card
             under gloo (NCCL refuses two ranks on one device), each held
             to 45% of it so that neither takes the memory cuDNN's plan
             choice depends on from the other, as (2,1) and
             (1,2): the learner's two sub-steps against one process (the
             losses and, where the gradient fixes them, the parameters
             within rtol 2e-5 / atol 2e-6, tests/test_torch_mesh.py's
             limits; below |g| = 100 eps/sqrt(1 - b2), where Adam's first
             step turns last-bit gradient differences into larger ones, at
             most 1e-4 of the elements beyond those limits, each by at most
             lr; the gradients within the train phase's 1e-4 of the
             net's largest), on (1,2) rank 0's bit-equal to the same calls
             with no mesh in its own process, each rank's (1,2) forward mask
             bit-equal to its own no-mesh forward, 5 cost-volume launches
             per forward on each rank, parameters bit-equal across ranks;
             per rank ms per generator and recover step (CUDA events),
             ms in one flat gradient reduction and, on (1,2), in its
             model-group broadcast alone (host clock), and peak memory.
             Where there
             are two cards, the same under NCCL on two cards; with one, a
             line says they were not run;
* repro   -- the port of tools/repro_mosaic_dynamic_dma.py (`dynamic_copy.
             repro`), the tile copy's own path: 2 launches, bit-equal;
* profile -- device time by kernel over three of the path's forwards in
             each dtype (torch.profiler), and the device's busy share.

`--times` runs only the kernels' timing, for the package under `--root`
(default: this checkout): the cost volume's and the warp's at batch 8
(r=4), summed over one forward, and both backward kernels at the pretrain
phase's batch 16 (r=4), per level and summed over one pretraining step;
its JSON line holds them all, with a digest of each forward kernel's
outputs over the levels, and ptxas' registers and spills are printed
when it builds. Given a `git archive` export of another
commit as `--root`, it times that commit's kernels with this script's
timer and inputs, so two commits compare, in time and in bits, in one
call on one card.

Any failed check raises, and the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available. The line
before the last is the card's name and power limit, the one before it a
JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
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
from unsupervised_detection_tpu_torch.device import precision_scope  # noqa: E402
from unsupervised_detection_tpu_torch.eval import Evaluator  # noqa: E402
from unsupervised_detection_tpu_torch.ops import _build  # noqa: E402
from unsupervised_detection_tpu_torch.ops.cost_volume import (  # noqa: E402
    cost_volume, cost_volume_backward, cost_volume_backward_plain, cost_volume_plain)
from unsupervised_detection_tpu_torch.ops.warp import (  # noqa: E402
    dense_image_warp, warp_backward, warp_backward_plain, warp_plain)

PHASES = ("card", "build", "kernels", "path", "eval", "postproc", "tf1", "jmean", "recipe",
          "gametools", "train", "pretrain", "mesh", "repro", "profile")
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
# Its control: the bfloat16 first step on another scene (seed 22, the
# next after the parity's 21) against float32's on seed 20 must break it.
# An untrained net's flow is near 0, so its EPE is near the scene's mean
# |flow|: 4.76 px on seed 20 and 5.52 on seed 22 (the scenes' flows made
# on the CPU), 16% apart.
PRETRAIN_CONTROL_SEED = 22
# bfloat16 against float32 in training, one generator_step and one
# recover_step at the train phase's sizes (batch 16) from the same weights
# and augmentation draws, on moving-square frames (`mesh_frames`), where
# a crop moves the square; fixed before the first card run:
# * the 8 losses within 3e-2 relative, the pretraining's limit: the
#   losses are means over ~1e6 per-pixel terms, and the same steps in
#   bfloat16 on the CPU (reader 256x384, batch 8) read 0.9% at most
#   (red_rate_compl);
# * the stepped net's applied gradient within 1.5e-2 relative L2 error of
#   the flattened whole: bfloat16's roundings of the weights and of every
#   activation perturb it by a fixed share that no batch averages away
#   (the CPU run: 8.8e-3 generator, 4.5e-3 recover).
# Control: the same bfloat16 steps on the next draw of the augmentation
# generator were to break at least one of the limits. On the CPU run the
# control read 2.0% on the losses and 2.5e-2 / 7.4e-3 on the gradients:
# only the generator step's gradient separated a changed draw from
# bfloat16's own error, by ~3x, and the gradient limit sat between them.
# On the H100 it did not (PERF.md section 6): at batch 16 the next
# draw (crop 0.9-1 and flips) moves the steps by less than bfloat16's
# roundings, so the control is printed and not held.
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_REL = 3e-2, 1.5e-2
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
# the postproc phase: the 4-crop ensemble (4B = 32 frames through PWC at
# batch 8) on the eval phase's batches at r=2, with the train phase's
# weights; the CLI chain on a JPEG tree of 2 x 6 frames at 480x854, at
# batch 4 (3 full batches: a wrapped last batch numbers its duplicates
# differently under each shift's sample order, and the soft score reads
# the same frames under every shift); frames at the working resolution
# for the propagation backend
ENSEMBLE_TOL = 1e-4        # crop-1.0 member vs Evaluator.infer, float32 card
DENSE_METRIC_TOL = 1e-6    # dense path's host metrics vs the device's
PWC_FLOW_REL = 1e-4        # pwc_flow_fn card vs CPU, of the flow's largest component
CHAIN_SEQS, CHAIN_FRAMES, CHAIN_BATCH = 2, 6, 4
SHIFTS = (-2, -1, 1, 2)
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
    sums over one forward's launches, per dtype: {dtype: {kernel: sums}};
    with each kernel's `digest`, a hash of its outputs at every level, so
    that two trees timed on the same inputs compare bit for bit."""
    import hashlib

    gen = torch.Generator(device="cuda").manual_seed(1)
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")
    totals = {}
    for dtype in DTYPES:
        dn = dtype_name(dtype)
        t = {k: dict.fromkeys(keys, 0.0) for k in ("cost_volume", "warp")}
        by = {k: {"bytes": 0.0, "operations": 0.0} for k in t}
        digests = {k: hashlib.sha256() for k in t}
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
                digests["warp"].update(dense_image_warp(c1, flow).float().cpu().numpy().tobytes())
            digests["cost_volume"].update(cost_volume(c1, wp, 4).float().cpu().numpy().tobytes())
            for name, row in rows.items():
                log("kernels: " + json.dumps({"time": f"{name} L{lvl} {dn} batch {BATCH}"
                                              + (" r=4" if name == "cost_volume" else ""),
                                              **row}))
                for k in keys:
                    t[name][k] += row.get(k, 0.0)
                by[name][row["bound_by"]] += row["bound_ms"]
        for name in t:
            t[name]["digest"] = digests[name].hexdigest()[:16]
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


def deterministic_cost(forwards: dict, img1, img2, iters: int, repeats: int) -> dict:
    """ms per forward under cuDNN's deterministic algorithms against the
    default, per dtype, in turns (default, deterministic, default,
    deterministic; the first default reading is phase path's own), with
    the launch counts of every timed window held."""
    from unsupervised_detection_tpu_torch.recipe.game import deterministic_cudnn

    timed = iters * repeats + 1
    out = {}
    for dn, (fwd, ms_default) in forwards.items():
        ms = {"default": [ms_default], "deterministic": []}
        for mode in ("deterministic", "default", "deterministic"):
            scope = deterministic_cudnn() if mode == "deterministic" else contextlib.nullcontext()
            reset_counts()
            with scope:
                ms[mode].append(time_cuda(fwd, img1, img2, iters=iters, warmup=1,
                                          repeats=repeats))
            expect_counts(f"timed forwards {dn} {mode} cuDNN", forwards=timed)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        out[dn] = {"ms": ms, "cost": mean["deterministic"] / mean["default"] - 1.0}
        log(f"path: forward {dn} batch {BATCH} cuDNN default {ms['default']} ms, deterministic "
            f"{ms['deterministic']} ms (CUDA events, in turns): deterministic costs "
            f"{100.0 * out[dn]['cost']:+.2f}% [{card_line()}]")
    return out


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
    report["deterministic_cudnn"] = deterministic_cost(
        {"float32": (fwd32, ms32), "bfloat16": (fwd16, ms16)}, img1, img2, iters, repeats)
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


def train_weights(seed: int = 0, head: float = 30.0) -> dict:
    """Seeded random weights of the three nets in the flax layout (numpy),
    at full width; the generator's head x `head` so that the mask spans
    [0, 1] and its gradients do not vanish."""
    from unsupervised_detection_tpu_torch.convert import random_jax_params, random_recover_params
    from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet

    gen_p, gen_s, pwc_p = random_jax_params(
        GeneratorNet(), PWCNet(search_range=TRAIN_SIZES["pwc_search_range"]), seed)
    gen_p["conv17"]["conv"]["kernel"] = gen_p["conv17"]["conv"]["kernel"] * head
    return {"gen_params": gen_p, "gen_stats": gen_s, "pwc_params": pwc_p,
            "rec_params": random_recover_params(RecoverNet(), seed + 1)}


def make_learner(cfg: Config, device: str, weights: dict, mesh=None):
    """An AdversarialLearner on `device` (and `mesh`, None: one process) and
    its initial state, the nets loaded from `weights` through convert.py."""
    from unsupervised_detection_tpu_torch.convert import from_jax_params, recover_state_dict
    from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner

    learner = AdversarialLearner(cfg, device=device, mesh=mesh)
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


def run_captured(fn, *args, prefix: str = "train: cli: ", **kw):
    """fn's result and what it printed (echoed to the log after `prefix`)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kw)
    for line in buf.getvalue().splitlines():
        if not line.startswith((" ", "{")):     # skip the pretty-printed config
            log(prefix + line)
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
        saved = sorted(f for f in os.listdir(ckpt_dir) if not f.startswith("events.out."))
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


def train_bf16_steps(cfg: Config, weights: dict, img1, img2, device: str = "cuda") -> dict:
    """One generator_step and one recover_step per run, each from the
    weights in `weights` and a fresh Adam state: float32 and bfloat16 on
    the first augmentation draw of a generator seeded Config.seed, and
    bfloat16 (the control) and float32 (what the draw alone moves) on its
    next draw. Returns {run: {step: (the 8 losses, the applied gradient
    flattened, float32 on the CPU)}}."""
    from unsupervised_detection_tpu_torch.ops.augment import sample_augment

    b, h, w, _ = img1.shape
    rng = torch.Generator().manual_seed(cfg.seed)
    draws = [sample_augment(rng, b, h, w, cfg.train_crop) for _ in range(2)]
    out = {}
    for run, dn, draw in (("float32", "float32", 0), ("bfloat16", "bfloat16", 0),
                          ("control", "bfloat16", 1), ("float32 next draw", "float32", 1)):
        learner, _ = make_learner(cfg.replace(compute_dtype=dn), device, weights)
        nets = (learner.objective.generator, learner.objective.recover)
        saved = [{k: v.clone() for k, v in net.state_dict().items()} for net in nets]
        out[run] = {}
        for name in ("generator_step", "recover_step"):
            for net, sd in zip(nets, saved):
                net.load_state_dict(sd)
            state, losses, grads = getattr(learner, name)(learner.init_state(), img1, img2,
                                                          draws=draws[draw])
            out[run][name] = ({k: float(v) for k, v in losses.items()},
                              torch.cat([g.detach().float().flatten() for g in grads]).cpu())
    return out


def hold_train_bf16(runs: dict) -> dict:
    """train_bf16_steps' bfloat16 run and its control against float32:
    each loss's relative difference and the gradient's relative L2 error,
    per step; raises unless the bfloat16 run holds both limits. Whether
    the control breaks one is printed: on the H100 it does not (PERF.md
    section 6), because the next draw moves these steps by less than
    bfloat16's roundings do."""
    out = {}
    for run in ("bfloat16", "control", "float32 next draw"):
        out[run] = {}
        for name, (losses, grad) in runs[run].items():
            want, g32 = runs["float32"][name]
            rel = {k: abs(losses[k] - want[k]) / max(abs(want[k]), 1e-30) for k in LOSS_KEYS}
            out[run][name] = {"loss_rel": max(rel.values()), "loss_rel_of": max(rel, key=rel.get),
                              "grad_rel_l2": float((grad - g32).norm() / g32.norm())}
    for run, steps in out.items():
        log(f"train: against float32 at batch {TRAIN_BATCH}, {run}: {json.dumps(steps)} (tol "
            f"losses {TRAIN_BF16_LOSS_RTOL} relative, gradient {TRAIN_BF16_GRAD_REL} relative "
            f"L2) [{card_line()}]")

    def holds(step):
        return (step["loss_rel"] <= TRAIN_BF16_LOSS_RTOL
                and step["grad_rel_l2"] <= TRAIN_BF16_GRAD_REL)

    misses = [f"bfloat16 {name} {step}" for name, step in out["bfloat16"].items()
              if not holds(step)]
    out["control_breaks"] = not all(holds(step) for step in out["control"].values())
    log(f"train: the control breaks a limit: {out['control_breaks']} (reported, not held)")
    if misses:
        raise AssertionError("train: bfloat16 against float32: " + "; ".join(misses))
    return out


def phase_train(report: dict) -> None:
    weights = train_weights()
    t0 = time.perf_counter()
    report["train_parity"] = train_parity(weights)
    log(f"train: parity {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg = Config(batch_size=TRAIN_BATCH, **TRAIN_SIZES)
    report["train_bf16"] = hold_train_bf16(
        train_bf16_steps(cfg, weights, *mesh_frames(TRAIN_BATCH, "cuda")))
    log(f"train: bf16 against float32 {time.perf_counter() - t0:.1f} s")
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
    control = None
    if dn == "bfloat16":
        loss, epe, _, _ = trainer.loss_and_grads(*scene(PRETRAIN_BATCH, PRETRAIN_CONTROL_SEED))
        control = {"loss": float(loss), "epe": float(epe)}
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
    return {"first": first, "control": control, "busy_share": busy_us / wall_us,
            "kernel_device_ms": kernel_ms}


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
    control = out["bfloat16"]["control"]
    rel = {k: abs(control[k] - f32[k]) / abs(f32[k]) for k in ("loss", "epe")}
    log(f"pretrain: control, the bfloat16 first step on scene seed {PRETRAIN_CONTROL_SEED}: "
        f"{json.dumps(control)}, relative to float32's on seed 20 {json.dumps(rel)} (must "
        f"exceed {PRETRAIN_BF16_RTOL})")
    if all(v <= PRETRAIN_BF16_RTOL for v in rel.values()):
        raise AssertionError(f"pretrain: the bfloat16 limit does not flag the control: {rel}")
    t0 = time.perf_counter()
    out["parity"] = pretrain_parity(cfg, weights)
    log(f"pretrain: parity {time.perf_counter() - t0:.1f} s")
    for dn in ("float32", "bfloat16"):
        out[dn]["learning"] = pretrain_learning(cfg, weights, dn)
        out[dn]["recover"] = pretrain_recover_run(dn)
    pretrain_chain(report)
    report["pretrain"] = out


def postproc_counts(what: str, forwards: int, warps: int | None = None,
                    counts: dict | None = None, phase: str = "postproc") -> dict:
    """Hold the launches since the last reset_counts (or `counts`) to
    `forwards` PWC forwards (5 cost volume and 4 warp each), or to `warps`
    warps alone, with no backward and no tile-copy launch; returns the
    counts."""
    counts = launch_counts() if counts is None else counts
    want = {"cost_volume": 5 * forwards, "warp": 4 * forwards if warps is None else warps,
            "dynamic_copy": 0, "cost_volume_backward": 0, "warp_backward": 0}
    log(f"{phase}: {what}: launches {json.dumps(counts)}")
    if counts != want:
        raise AssertionError(f"{phase} {what}: launches {counts}, expected {want}")
    return counts


def ensemble_dataset(ens, batches) -> dict:
    """The ensemble CLI's metrics (each frame the mean over its crops) over
    `batches`, counts from 0 and held after every batch; with the counts
    of the whole run."""
    import numpy as np

    from unsupervised_detection_tpu_torch.eval.ensemble import crop_metrics

    ious, maes = [], []
    reset_counts()
    for n, batch in enumerate(batches, 1):
        out = ens.run(batch)
        counts = postproc_counts(f"ensemble {dtype_name(ens.objective.dtype)} after batch {n}", n)
        for b in range(out["pred_masks"].shape[1]):
            i, m, _ = crop_metrics(out, b)
            ious.append(float(np.mean(i)))
            maes.append(float(np.mean(m)))
    return {"dataset_iou": float(np.mean(ious)), "dataset_mae": float(np.mean(maes)),
            "frames": len(ious), "launches": counts}


def postproc_ensemble(cfg: Config, nets: dict, batches, report: dict):
    """EnsembleEvaluator at batch 8 in both dtypes on the eval phase's
    batches: launches, frames/s, busy share, the crop-1.0 member against
    Evaluator.infer, card vs CPU at B=1, bfloat16 vs float32 with a control
    that the limits must flag, and the kernels against their plain versions
    at 4B = 32."""
    import numpy as np

    from unsupervised_detection_tpu_torch.eval import TEST_CROPS, EnsembleEvaluator
    from unsupervised_detection_tpu_torch.eval import ensemble as ensemble_module

    first = next(iter(batches))
    res = {}
    for dn in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dn)
        ens = EnsembleEvaluator(c, device="cuda")
        ens.load_state_dicts(*nets)
        res[dn] = ensemble_dataset(ens, batches)
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for batch in batches:
                ens.run(batch)
            walls.append(time.perf_counter() - t0)
        walls.sort()
        fps = res[dn]["frames"] / walls[1]
        wall_us, busy, _ = profile_window(lambda: ens.run(first), 1)
        log(f"postproc: ensemble {dn} batch {BATCH} ({4 * BATCH} crops through PWC): {fps:.2f} "
            f"frames/s ({res[dn]['frames']} frames in {walls[1] * 1e3:.3f} ms, median of 3; "
            f"frames from arrays, host metrics included); one batch under the profiler "
            f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
            f"({100.0 * busy / wall_us:.1f}%); 4-crop-mean dataset IoU "
            f"{res[dn]['dataset_iou']} MAE {res[dn]['dataset_mae']} [{card_line()}]")
        res[dn]["fps"] = fps
        res[dn]["busy_share"] = busy / wall_us
        res[dn]["kernel_err"] = check_step_kernels(lambda: ens.run(first),
                                                   f"ensemble 4B={4 * BATCH}")
        if dn == "float32":
            ens32 = ens
        else:
            ens16 = ens

    def bf16_diffs(r: dict) -> tuple[float, float]:
        return (abs(r["dataset_iou"] - res["float32"]["dataset_iou"]),
                abs(r["dataset_mae"] - res["float32"]["dataset_mae"]))

    d_iou, d_mae = bf16_diffs(res["bfloat16"])
    log(f"postproc: ensemble bfloat16 vs float32: abs diff IoU {d_iou} (tol {BF16_IOU_TOL}), "
        f"MAE {d_mae} (tol {BF16_MAE_TOL})")
    if not (d_iou <= BF16_IOU_TOL and d_mae <= BF16_MAE_TOL):
        raise AssertionError(f"postproc: bfloat16 ensemble differs by IoU {d_iou}, MAE {d_mae}")
    # control: a bfloat16 ensemble fault the limits must see, the crop grid
    # skipped (every member at crop 1.0), through the same comparison
    ensemble_module.TEST_CROPS = [1.0] * len(TEST_CROPS)
    try:
        f_iou, f_mae = bf16_diffs(ensemble_dataset(ens16, batches))
    finally:
        ensemble_module.TEST_CROPS = TEST_CROPS
    log(f"postproc: control, bfloat16 ensemble without the crop grid vs float32: abs diff IoU "
        f"{f_iou}, MAE {f_mae}")
    if f_iou <= BF16_IOU_TOL and f_mae <= BF16_MAE_TOL:
        raise AssertionError("postproc: the bfloat16 limits do not flag a skipped crop grid")

    # the crop-1.0 member is Evaluator.infer at test_crop=1.0
    ev = Evaluator(cfg.replace(test_crop=1.0), device="cuda")
    ev.load_state_dicts(*nets)
    out = ens32.infer(*ens32.feeder.images(first), ens32.feeder.mask(first))
    plain = ev.infer(*ev.device_batch(first))
    full = TEST_CROPS.index(1.0)
    err = (out["pred_masks"][full] - plain["gen_masks"]).abs().max().item()
    log(f"postproc: crop-1.0 member vs Evaluator.infer, float32: max abs err {err} "
        f"(tol {ENSEMBLE_TOL}); gt equal {torch.equal(out['gt_masks'][full], plain['gt_masks'])}")
    if not err <= ENSEMBLE_TOL or not torch.equal(out["gt_masks"][full], plain["gt_masks"]):
        raise AssertionError(f"postproc: crop-1.0 member differs from Evaluator.infer by {err}")

    # card vs CPU, one sample (4 crops)
    one = {k: v[:1] for k, v in first.items() if k.endswith("_raw")}
    ens_cpu = EnsembleEvaluator(cfg.replace(batch_size=1), device="cpu")
    ens_cpu.load_state_dicts(*nets)
    t0 = time.perf_counter()
    got, want = ens32.run(one), ens_cpu.run(one)
    err = float(np.abs(got["pred_masks"] - want["pred_masks"]).max())
    log(f"postproc: ensemble B=1 float32 card vs CPU: mask max abs err {err} (tol {MASK_TOL}); "
        f"gt {float(np.abs(got['gt_masks'] - want['gt_masks']).max())}, img_1s "
        f"{float(np.abs(got['img_1s'] - want['img_1s']).max())} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not err <= MASK_TOL:
        raise AssertionError(f"postproc: ensemble card vs CPU {err} > {MASK_TOL}")
    report["postproc_ensemble"] = res


def postproc_dense(cfg: Config, nets: dict, batches, tmp: str) -> dict:
    """evaluate_dataset's dense path against its metrics-only path on the
    same batches: one PNG and one .mat per frame; the host metrics equal to
    DENSE_METRIC_TOL to the device's on the same masks (the metrics-only
    path replayed on the masks the dense run produced), and within
    METRIC_TOL to a second forward. Two float32 forwards of the card may
    differ in the last bits (cuDNN picks its algorithms per call), which
    moves a mask value lying at the 0.1 threshold to the other side: one
    pixel moves a frame's MAE by 1/(192*384) = 1.4e-5."""
    import scipy.io as sio

    from unsupervised_detection_tpu_torch.eval import evaluate_dataset
    from unsupervised_detection_tpu_torch.ops.metrics import eval_iou_mae

    ev = Evaluator(cfg, device="cuda")
    ev.load_state_dicts(*nets)
    save = os.path.join(tmp, "dense")
    masks = []
    infer = ev.infer

    def recording(*args):
        out = infer(*args)
        masks.append((out["gen_masks"], out["gt_masks"]))
        return out

    ev.infer = recording
    reset_counts()
    t0 = time.perf_counter()
    try:
        dense = evaluate_dataset(cfg, ev, save_dir=save, generate_visualization=True,
                                 batches=batches, verbose=False)
        torch.cuda.synchronize()
    finally:
        del ev.infer
    wall = time.perf_counter() - t0
    postproc_counts("dense evaluate_dataset", batches.num_steps)
    replay = iter(masks)

    def replayed(*_):
        mask, gt = next(replay)
        iou, mae = eval_iou_mae(mask, gt)
        return {"iou": iou, "mae": mae}

    ev.infer_metrics = replayed
    try:
        same = evaluate_dataset(cfg, ev, batches=batches, verbose=False)
    finally:
        del ev.infer_metrics
    second = evaluate_dataset(cfg, ev, batches=batches, verbose=False)
    diffs, diffs2 = ({f"{kind}[{cat}]": abs(dense[kind][cat] - v)
                      for kind in ("category_iou", "category_mae")
                      for cat, v in res[kind].items()} for res in (same, second))
    first = next(iter(batches))
    a, b = (ev.infer(*ev.device_batch(first))["gen_masks"] for _ in range(2))
    flips = int(((a > 0.1) != (b > 0.1)).sum())
    files = {cat: sorted(os.listdir(os.path.join(save, cat))) for cat in dense["category_iou"]}
    n_png = sum(f.endswith(".png") for fs in files.values() for f in fs)
    n_mat = sum(f.endswith(".mat") for fs in files.values() for f in fs)
    some = sio.loadmat(os.path.join(save, next(iter(files)), "result_1.mat"))
    keys = sorted(k for k in some if not k.startswith("__"))
    log(f"postproc: dense evaluate_dataset float32: {dense['frames']} frames in {wall:.3f} s "
        f"({dense['frames'] / wall:.2f} frames/s, PNG and .mat writes included), {n_png} PNG, "
        f"{n_mat} .mat, keys {keys}; host vs device metrics on the same masks: max abs diff "
        f"{max(diffs.values())} (tol {DENSE_METRIC_TOL}); vs a second forward: "
        f"{max(diffs2.values())} (tol {METRIC_TOL}); two infers of one batch: max abs diff "
        f"{(a - b).abs().max().item()}, {flips} of {a.numel()} pixels across 0.1")
    if (n_png != dense["frames"] or n_mat != dense["frames"]
            or keys != ["flow", "gt_mask", "img1", "pred_mask"]
            or not all(d <= DENSE_METRIC_TOL for d in diffs.values())
            or not all(d <= METRIC_TOL for d in diffs2.values())):
        raise AssertionError(f"postproc: dense path: {n_png} PNG, {n_mat} .mat, keys {keys}, "
                             f"metric diffs {diffs} and {diffs2}")
    return {"frames_per_s": dense["frames"] / wall, "repeat_flips": flips,
            "same_mask_diff": max(diffs.values()), "second_forward_diff": max(diffs2.values())}


class StageTimer:
    """Wraps module functions to sum their wall seconds and the kernel
    launches made during them (nested calls included in the caller's
    totals)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.launches: dict[str, dict] = {}
        self._saved = []

    def wrap(self, module, name: str) -> None:
        fn = getattr(module, name)

        def timed(*args, **kw):
            before = launch_counts()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
                total = self.launches.setdefault(name, dict.fromkeys(before, 0))
                for k, n in launch_counts().items():
                    total[k] += n - before[k]

        self._saved.append((module, name, fn))
        setattr(module, name, timed)

    def restore(self) -> None:
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved.clear()


def postproc_chain(tmp: str, weights: dict, report: dict) -> dict:
    """The ensemble CLI for the four shifts on a port training save, then
    the post-processing CLI with the PWC backend on the card; the stages'
    seconds per frame; the native CRF backend named."""
    from unsupervised_detection_tpu_torch import post_processing, test_generator_ensemble
    from unsupervised_detection_tpu_torch.postproc import crf, propagate, soft_score
    from unsupervised_detection_tpu_torch.train import checkpoint

    root = write_davis_tree(os.path.join(tmp, "davis"), sequences=CHAIN_SEQS,
                            frames=CHAIN_FRAMES)
    cfg = Config(batch_size=CHAIN_BATCH, **TRAIN_SIZES)
    _, state = make_learner(cfg, "cuda", weights)
    os.makedirs(os.path.join(tmp, "ckpt"))
    ckpt = checkpoint.save_best(os.path.join(tmp, "ckpt"), state)
    pwc_ckpt = checkpoint.save_scope(os.path.join(tmp, "ckpt"), "pwc-final", state.pwc,
                                     "pwc_params")
    frames = CHAIN_SEQS * CHAIN_FRAMES
    buf = os.path.join(tmp, "buffer")
    flags = [f"--root_dir={root}", f"--ckpt_file={ckpt}", "--pwc_search_range=2",
             f"--batch_size={CHAIN_BATCH}", "--num_threads=4", "--test_partition=trainval",
             "--generate_visualization"]
    t0 = time.perf_counter()
    for s in SHIFTS:
        reset_counts()
        res, text = run_captured(test_generator_ensemble.main, flags + [
            f"--test_temporal_shift={s}", f"--test_save_dir={buf}/davis_shift_{s}"],
            prefix=f"postproc: ensemble cli shift {s}: ")
        postproc_counts(f"ensemble CLI shift {s}", frames // CHAIN_BATCH)
        if res["frames"] != frames or "The Average over the dataset: IoU is" not in text:
            raise AssertionError(f"ensemble CLI shift {s}: {text[-300:]!r}")
    ens_s = time.perf_counter() - t0

    timer = StageTimer()
    timer.wrap(soft_score, "buffer_to_soft_score")
    timer.wrap(propagate, "propagate_sequences")
    timer.wrap(crf, "run_crf")
    reset_counts()
    t0 = time.perf_counter()
    try:
        out, text = run_captured(post_processing.main, [
            f"--path_buffer={buf}", f"--out_soft_score={tmp}/soft",
            f"--resized_out={tmp}/crf", "--flow_backend=pwc", f"--flow_ckpt={pwc_ckpt}",
            "--pwc_search_range=2", "--discover_sequences"], prefix="postproc: cli: ")
    finally:
        timer.restore()
    wall = time.perf_counter() - t0
    # two passes over each sequence, one PWC call per frame pair
    pairs = 2 * CHAIN_SEQS * (CHAIN_FRAMES - 1)
    postproc_counts("post_processing CLI (PWC backend)", pairs)
    backend = crf.backend_name()
    sec = timer.seconds
    per_frame = {"soft_score": (sec["buffer_to_soft_score"] - sec["propagate_sequences"]) / frames,
                 "propagation": sec["propagate_sequences"] / frames,
                 "crf": sec["run_crf"] / frames}
    log(f"postproc: chain: ensemble CLI x4 shifts {ens_s:.2f} s; post_processing {wall:.2f} s, "
        f"CRF backend {backend}; seconds per frame {json.dumps(per_frame)} ({frames} frames, "
        f"{pairs} PWC pairs); resized CRF IoU {out['iou_resized']} [{card_line()}]")
    if backend != "native" or "Propagation flow backend: pwc" not in text:
        raise AssertionError(f"postproc: CLI ran the {backend} CRF: {text[-300:]!r}")
    if not 0.0 <= out["iou_resized"] <= 1.0:
        raise AssertionError(f"postproc: resized CRF IoU {out['iou_resized']}")
    report["postproc_chain"] = {"per_frame_s": per_frame, "iou_resized": out["iou_resized"]}
    return {"pwc_ckpt": pwc_ckpt, "soft": os.path.join(tmp, "soft")}


def postproc_propagation(chain: dict, report: dict) -> None:
    """pwc_flow_fn card vs CPU on one frame pair, its launches and kernels,
    ms per pair."""
    import numpy as np
    import scipy.io as sio

    from unsupervised_detection_tpu_torch.postproc import propagate

    seq = sorted(os.listdir(chain["soft"]))[0]
    mats = [sio.loadmat(os.path.join(chain["soft"], seq, f"result_{k}.mat"))
            for k in range(1, CHAIN_FRAMES + 1)]
    images = [np.squeeze(m["img1"]).astype(np.float64) / 255.0 for m in mats]
    masks = np.stack([np.squeeze(m["pred_mask"]) for m in mats]).astype(np.float32)
    h, w = masks.shape[1:]

    flow_fn = propagate.pwc_flow_fn(chain["pwc_ckpt"], search_range=2, device="cuda")
    cpu_fn = propagate.pwc_flow_fn(chain["pwc_ckpt"], search_range=2, device="cpu")
    reset_counts()
    got = flow_fn(images[1], images[0])
    postproc_counts("pwc_flow_fn one pair", 1)
    want = cpu_fn(images[1], images[0])
    top = max(float(np.abs(x).max()) for x in want)
    err = max(float(np.abs(g - x).max()) for g, x in zip(got, want))
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        flow_fn(images[1], images[0])
        walls.append(time.perf_counter() - t0)
    walls.sort()
    log(f"postproc: pwc_flow_fn {h}x{w} float32 card vs CPU: max abs err {err} of the flow's "
        f"largest {top} (tol {PWC_FLOW_REL} of it); {walls[5] * 1e3:.3f} ms per pair "
        f"(median of 10, host clock, transfers included) [{card_line()}]")
    if not err <= PWC_FLOW_REL * top:
        raise AssertionError(f"postproc: pwc_flow_fn card vs CPU {err} > {PWC_FLOW_REL} * {top}")
    kernel_err = check_step_kernels(lambda: flow_fn(images[1], images[0]), f"pwc backend {h}x{w}")
    report["postproc_propagation"] = {"pwc_pair_ms": walls[5] * 1e3, "kernel_err": kernel_err}


def phase_postproc(report: dict) -> None:
    """The post-processed evaluation path at full width (reader 384x640,
    working 192x384, PWC 6 levels r=2, generator cnum 32, recover f=0.25,
    seeded random weights): the ensemble, the dense evaluation, the CLI
    chain ensemble -> post-processing and the PWC propagation backend."""
    import tempfile

    from unsupervised_detection_tpu_torch.convert import from_jax_params

    # the eval phase's generator and PWC weights (seed 0, head x 100), for
    # which the bfloat16 limits were set: with the train phase's head x 30
    # the masks saturate less and the ensemble's bfloat16 MAE moved 3.9e-3
    # (H100 reading)
    weights = train_weights(head=100.0)
    nets = from_jax_params(weights["gen_params"], weights["gen_stats"], weights["pwc_params"])
    cfg = Config(batch_size=BATCH, **TRAIN_SIZES)
    batches = eval_batches()
    postproc_ensemble(cfg, nets, batches, report)
    # the path's own run: the float32 ensemble over every batch
    report["launches_postproc"] = report["postproc_ensemble"]["float32"]["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        postproc_dense(cfg, nets, batches, tmp)
        chain = postproc_chain(tmp, weights, report)
        postproc_propagation(chain, report)


# --- phase tf1: the reference's TF1 checkpoints -------------------------------
TF1_EVAL_RANGE, TF1_TRAIN_RANGE = 4, 2     # the reference's PWC bundles; the train phase's
TF1_SUBSTEPS, TF1_SUMMARY_FREQ = 8, 2
SUMMARY_IMAGES = ("input_image", "next_image", "masked_flow", "PWC_Flow", "Rec_flow",
                  "Rec_flow_compl")


def tf1_weights(search_range: int, seed: int = 20) -> dict:
    """Seeded full-width weights of the three nets in the flax layout
    (generator cnum 32, recover f=0.25, PWC at `search_range`), the
    generator's head x 100 (the eval phase's sharp head)."""
    from unsupervised_detection_tpu_torch.convert import random_jax_params, random_recover_params
    from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet

    gen_p, gen_s, pwc_p = random_jax_params(GeneratorNet(), PWCNet(search_range=search_range),
                                            seed)
    gen_p["conv17"]["conv"]["kernel"] = gen_p["conv17"]["conv"]["kernel"] * 100.0
    return {"gen_params": gen_p, "gen_stats": gen_s, "pwc_params": pwc_p,
            "rec_params": random_recover_params(RecoverNet(), seed + 1)}


def tf1_nets(weights: dict, search_range: int):
    """The three port nets on the CPU with `weights`, as a state for
    export_tf1_checkpoint."""
    import types

    from unsupervised_detection_tpu_torch.convert import from_jax_params, recover_state_dict
    from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet

    state = types.SimpleNamespace(generator=GeneratorNet(), recover=RecoverNet(),
                                  pwc=PWCNet(search_range=search_range), step=123)
    gen_sd, pwc_sd = from_jax_params(weights["gen_params"], weights["gen_stats"],
                                     weights["pwc_params"])
    state.generator.load_state_dict(gen_sd)
    state.pwc.load_state_dict(pwc_sd)
    state.recover.load_state_dict(recover_state_dict(weights["rec_params"]))
    return state


def tf1_round_trip(tmp: str, weights: dict, search_range: int) -> dict:
    """export_tf1_checkpoint of the nets, read back with read_bundle: every
    tensor bit-equal; the bundle's bytes and the write and read seconds
    (crc32c included)."""
    import numpy as np

    from unsupervised_detection_tpu_torch.train.tf1_bundle import data_path, read_bundle
    from unsupervised_detection_tpu_torch.train.tf1_export import (export_tf1_checkpoint,
                                                                   tf1_tensors)

    state = tf1_nets(weights, search_range)
    want = {k: v for net in (state.generator, state.recover, state.pwc)
            for k, v in tf1_tensors(net).items()}
    t0 = time.perf_counter()
    prefix = export_tf1_checkpoint(state, os.path.join(tmp, f"r{search_range}", "model.ckpt"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = read_bundle(prefix)
    read_s = time.perf_counter() - t0
    nbytes = os.path.getsize(prefix + ".index") + os.path.getsize(data_path(prefix))
    bad = [k for k, v in want.items() if k not in got or got[k].dtype != np.float32
           or not np.array_equal(got[k], v)]
    n_values = sum(v.size for v in want.values())
    log(f"tf1: bundle r={search_range}: {len(got)} variables, {n_values} float32 values, "
        f"{nbytes} bytes; write {write_s:.3f} s, read {read_s:.3f} s (crc32c included; host) "
        f"[{card_line()}]")
    if bad or set(got) != set(want) | {"global_step"} or int(got["global_step"]) != 123:
        raise AssertionError(f"tf1: bundle r={search_range} round trip: {bad[:5]}, "
                             f"{sorted(set(got) ^ (set(want) | {'global_step'}))[:5]}")
    return {"prefix": prefix, "bytes": nbytes, "write_s": write_s, "read_s": read_s}


def tf1_eval(tmp: str, root: str, weights: dict, prefix: str, prefix_r2: str,
             report: dict) -> None:
    """test_generator on a JPEG tree from the r=4 bundle and from the .npz
    of the same weights, float32 and bfloat16: the restored state dicts
    bit-equal, the metrics within METRIC_TOL, 5 + 4 launches per batch; an
    r=2 bundle at r=4 refused, naming both ranges."""
    from unsupervised_detection_tpu_torch import test_generator
    from unsupervised_detection_tpu_torch.train.checkpoint import (load_eval_checkpoint,
                                                                   save_eval_checkpoint)

    npz = save_eval_checkpoint(os.path.join(tmp, "model.npz"), weights["gen_params"],
                               weights["gen_stats"], weights["pwc_params"])
    loaded = {}
    for kind, path in (("bundle", prefix), ("npz", npz)):
        t0 = time.perf_counter()
        loaded[kind] = load_eval_checkpoint(path, TF1_EVAL_RANGE)
        log(f"tf1: load_eval_checkpoint {kind}: {time.perf_counter() - t0:.3f} s (host)")
    for got, want in zip(loaded["bundle"], loaded["npz"]):
        if set(got) != set(want) or not all(torch.equal(got[k], v) for k, v in want.items()):
            raise AssertionError("tf1: the bundle's state dicts differ from the .npz's")
    log("tf1: the bundle's and the .npz's state dicts are bit-equal")

    frames = 2 * 10
    batches = -(-frames // BATCH)
    flags = [f"--root_dir={root}", f"--pwc_search_range={TF1_EVAL_RANGE}",
             f"--batch_size={BATCH}", "--test_partition=trainval", "--num_threads=4"]
    for dn in ("float32", "bfloat16"):
        res = {}
        for kind, path in (("bundle", prefix), ("npz", npz)):
            reset_counts()
            t0 = time.perf_counter()
            res[kind], _ = run_captured(test_generator.main, flags + [
                f"--ckpt_file={path}", f"--compute_dtype={dn}"],
                prefix=f"tf1: test_generator {dn} {kind}: ")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = expect_counts(f"tf1 test_generator {dn} {kind}", forwards=batches)
            backward = [launch_counts()[k] for k in (*BACKWARD_KERNELS, "dynamic_copy")]
            if backward != [0, 0, 0] or res[kind]["frames"] != batches * BATCH:
                raise AssertionError(f"tf1: {dn} {kind}: launches {launch_counts()}, "
                                     f"frames {res[kind]['frames']}")
            if dn == "float32" and kind == "bundle":
                report["launches_tf1"] = dict(zip(("cost_volume", "warp"), counts))
            log(f"tf1: test_generator {dn} {kind}: {wall:.2f} s for {res[kind]['frames']} "
                f"frames (JPEG decode and start-up included) [{card_line()}]")
        a, b = res["bundle"], res["npz"]
        diffs = {k: abs(a[k] - b[k]) for k in ("dataset_iou", "dataset_mae")}
        for kind in ("category_iou", "category_mae"):
            for cat, v in b[kind].items():
                diffs[f"{kind}[{cat}]"] = abs(a[kind][cat] - v)
        log(f"tf1: {dn} bundle vs .npz (dataset IoU {b['dataset_iou']}, MAE "
            f"{b['dataset_mae']}): max abs diff {max(diffs.values())} (tol {METRIC_TOL}) "
            f"{json.dumps(diffs)}")
        if list(a["category_iou"]) != list(b["category_iou"]) or not all(
                d <= METRIC_TOL for d in diffs.values()):
            raise AssertionError(f"tf1: {dn} bundle vs .npz metrics: {diffs}")
        report.setdefault("tf1", {})[f"eval_diff_{dn}"] = max(diffs.values())
    try:
        run_captured(test_generator.main, flags + [f"--ckpt_file={prefix_r2}"],
                     prefix="tf1: refusal: ")
    except ValueError as err:
        log(f"tf1: an r=2 bundle at --pwc_search_range={TF1_EVAL_RANGE} refused: {err}")
        if f"search range 2, but --pwc_search_range={TF1_EVAL_RANGE}" not in str(err):
            raise
    else:
        raise AssertionError("tf1: an r=2 bundle was read at r=4")


def tf1_pwc_backend(tmp: str, weights: dict, prefix: str, report: dict) -> None:
    """pwc_flow_fn from the r=4 bundle against the same net from a PWC scope
    save, one 192x384 pair, float32 on the card."""
    import numpy as np

    from unsupervised_detection_tpu_torch.postproc import propagate
    from unsupervised_detection_tpu_torch.train import checkpoint

    pwc = tf1_nets(weights, TF1_EVAL_RANGE).pwc
    scope = checkpoint.save_scope(tmp, "pwc-r4", pwc, "pwc_params")
    rs = np.random.RandomState(5)
    big = rs.rand(200, 400, 3)
    for axis in (0, 1):
        big = (big + np.roll(big, 1, axis) + np.roll(big, -1, axis)) / 3.0
    im_a, im_b = big[4:196, 8:392], big[2:194, 5:389]
    from_bundle = propagate.pwc_flow_fn(prefix, search_range=TF1_EVAL_RANGE, device="cuda")
    from_scope = propagate.pwc_flow_fn(scope, search_range=TF1_EVAL_RANGE, device="cuda")
    reset_counts()
    got = from_bundle(im_a, im_b)
    torch.cuda.synchronize()
    expect_counts("tf1 pwc_flow_fn from the bundle")
    want = from_scope(im_a, im_b)
    top = max(float(np.abs(x).max()) for x in want)
    err = max(float(np.abs(g - x).max()) for g, x in zip(got, want))
    log(f"tf1: pwc_flow_fn 192x384 from the bundle vs a scope save: max abs diff {err} of the "
        f"flow's largest {top} (tol {PWC_FLOW_REL} of it) [{card_line()}]")
    if not err <= PWC_FLOW_REL * top:
        raise AssertionError(f"tf1: pwc_flow_fn bundle vs scope save {err} > "
                             f"{PWC_FLOW_REL} * {top}")
    report.setdefault("tf1", {})["pwc_flow_diff"] = err


def summary_writers():
    """(tensorboardX's version or None, the writer class the writer run
    uses): tensorboardX's, which the driver takes; where it does not import
    (the driver's writer is then None, as in the JAX package), PyTorch's
    `torch.utils.tensorboard.SummaryWriter` (the same add_* calls, over the
    `tensorboard` package) stands in, so that the summaries' cost is still
    measured; None when neither imports."""
    try:
        import tensorboardX
    except ImportError as err:
        log(f"tf1: tensorboardX does not import here ({err}): the train driver's writer is "
            "None, as in the JAX package")
    else:
        log(f"tf1: tensorboardX {tensorboardX.__version__} imports here")
        return tensorboardX.__version__, tensorboardX.SummaryWriter
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as err:
        log(f"tf1: torch.utils.tensorboard does not import either ({err}): no writer run")
        return None, None
    log("tf1: torch.utils.tensorboard's SummaryWriter stands in for tensorboardX in the "
        "writer run")
    return None, SummaryWriter


def event_tags(path: str) -> dict:
    """{"scalars", "histograms", "images"}: the summary tags of an event
    file (TFRecord framing; tensorboardX's protos, or tensorboard's)."""
    import struct

    try:
        from tensorboardX.proto import event_pb2
    except ImportError:
        from tensorboard.compat.proto import event_pb2

    tags = {"scalars": set(), "histograms": set(), "images": set()}
    kinds = {"simple_value": "scalars", "histo": "histograms", "image": "images"}
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos < len(data):
        (n,) = struct.unpack_from("<Q", data, pos)
        event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
        pos += 12 + n + 4
        for v in event.summary.value:
            tags[kinds[v.WhichOneof("value")]].add(v.tag)
    return tags


def tf1_train(tmp: str, prefix_r2: str, report: dict) -> None:
    """The train CLI on a JPEG tree with --flow_ckpt and --recover_ckpt the
    r=2 bundle and --summary_freq=2; without the writer, with it (its event
    file's tags checked), and without it again; samples/s of each and the
    writer's seconds."""
    import importlib
    import re

    from unsupervised_detection_tpu_torch.convert import flax_paths
    from unsupervised_detection_tpu_torch.models import GeneratorNet, RecoverNet
    from unsupervised_detection_tpu_torch.train import driver
    from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner

    cli = importlib.import_module("unsupervised_detection_tpu_torch.train.__main__")
    version, writer_class = summary_writers()
    root = write_davis_tree(os.path.join(tmp, "davis_train"))
    flags = [f"--root_dir={root}", f"--pwc_search_range={TF1_TRAIN_RANGE}",
             f"--batch_size={TRAIN_BATCH}", "--num_threads=4", f"--flow_ckpt={prefix_r2}",
             f"--recover_ckpt={prefix_r2}", f"--num_samples_train={TF1_SUBSTEPS * TRAIN_BATCH}",
             "--max_epochs=1", f"--summary_freq={TF1_SUMMARY_FREQ}", "--save_freq=1"]
    summaries = TF1_SUBSTEPS // TF1_SUMMARY_FREQ
    val_batches = -(-10 // TRAIN_BATCH)
    rate = re.compile(rf"\[ *{TF1_SUBSTEPS}/ *{TF1_SUBSTEPS}\] time: \S+ \((\S+) samples/s\)")
    runs = {}
    labels = ("no writer", "writer", "no writer again") if writer_class else ("no writer",)
    for label in labels:
        ckpt_dir = os.path.join(tmp, "train_" + label.replace(" ", "_"))
        timer = StageTimer()
        timer.wrap(driver, "_write_summaries")
        if label == "writer":      # where the summaries' seconds go
            timer.wrap(AdversarialLearner, "summary_images")
            timer.wrap(writer_class, "add_histogram")
            timer.wrap(writer_class, "add_image")
        writer = driver._writer
        driver._writer = writer_class if label == "writer" else (lambda logdir: None)
        reset_counts()
        t0 = time.perf_counter()
        try:
            _, text = run_captured(cli.main, flags + [f"--checkpoint_dir={ckpt_dir}"],
                                   prefix=f"tf1: train cli ({label}): ")
        finally:
            driver._writer = writer
            timer.restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        written = summaries if label == "writer" else 0
        expect_counts(f"tf1 train cli ({label})",
                      forwards=TF1_SUBSTEPS + written + val_batches)
        if not all(s in text for s in (f"Flow net loaded from {prefix_r2}",
                                        "Recover net loaded from previous ckpt",
                                        "Training completed successfully")):
            raise AssertionError(f"tf1: train cli ({label}): {text[-400:]!r}")
        m = rate.search(text)
        run = runs[label] = {"samples_per_s": float(m.group(1)), "wall_s": wall,
                             "writer_s": timer.seconds.get("_write_summaries", 0.0)}
        which = f" {writer_class.__module__}.SummaryWriter" if label == "writer" else ""
        log(f"tf1: train cli ({label}{which}), fp32 r=2 batch {TRAIN_BATCH}, {TF1_SUBSTEPS} "
            f"sub-steps, summaries every {TF1_SUMMARY_FREQ}: {run['samples_per_s']} samples/s "
            f"(the driver's rolling rate), {wall:.2f} s wall, {run['writer_s']:.3f} s in "
            f"_write_summaries [{card_line()}]")
        if label == "writer":
            run["parts_s"] = {k: v for k, v in timer.seconds.items() if k != "_write_summaries"}
            log(f"tf1: of those, in {summaries} summaries (the gradients' and images' copies "
                f"to the host and the rest are not split out): {json.dumps(run['parts_s'])}")
        events = [f for f in os.listdir(ckpt_dir) if f.startswith("events.out.tfevents.")]
        if label != "writer":
            if events:
                raise AssertionError(f"tf1: train cli ({label}) wrote {events}")
            continue
        tags = event_tags(os.path.join(ckpt_dir, events[0]))
        want = {"scalars": set(LOSS_KEYS) | {"samples_per_sec", "IoU_on_Validation"},
                "images": set(SUMMARY_IMAGES), "histograms": {
                    f"{scope}/{'/'.join(flax_paths(net)[name][1:])}/gradients"
                    for scope, net in (("MaskNet", GeneratorNet()), ("FlownetS", RecoverNet()))
                    for name, _ in net.named_parameters()}}
        log(f"tf1: event file {events[0]}: {len(tags['scalars'])} scalar, "
            f"{len(tags['histograms'])} histogram, {len(tags['images'])} image tags")
        if len(events) != 1 or tags != want:
            raise AssertionError(f"tf1: event tags differ: "
                                 f"{ {k: sorted(tags[k] ^ want[k])[:6] for k in want} }")
    report.setdefault("tf1", {})["train"] = runs
    report["tf1"]["tensorboardX"] = version
    report["tf1"]["writer"] = writer_class and f"{writer_class.__module__}.SummaryWriter"


def phase_tf1(report: dict) -> None:
    """TF1 bundles at full width: the round trip at r=4 and r=2, the
    evaluation CLI from a bundle against the .npz of the same weights, the
    range refusal, the PWC backend from a bundle, and the train CLI from
    bundles with the TensorBoard writer and without it."""
    import tempfile

    weights = {r: tf1_weights(r) for r in (TF1_EVAL_RANGE, TF1_TRAIN_RANGE)}
    with tempfile.TemporaryDirectory() as tmp:
        trips = {r: tf1_round_trip(tmp, w, r) for r, w in weights.items()}
        report["tf1"] = {"bundles": {r: {k: v for k, v in t.items() if k != "prefix"}
                                     for r, t in trips.items()}}
        root = write_davis_tree(os.path.join(tmp, "davis"))
        tf1_eval(tmp, root, weights[TF1_EVAL_RANGE], trips[TF1_EVAL_RANGE]["prefix"],
                 trips[TF1_TRAIN_RANGE]["prefix"], report)
        tf1_pwc_backend(tmp, weights[TF1_EVAL_RANGE], trips[TF1_EVAL_RANGE]["prefix"], report)
        tf1_train(tmp, trips[TF1_TRAIN_RANGE]["prefix"], report)


# --- phase jmean: the flagship's trained weights, end to end ------------------
# The committed export of the flagship (experiments/game_state_v2lr/model.best
# with experiments/pwc_ckpt_v2/pwc-final, r=2; weights_torch/README.md) on
# the 5 x 24 frames that e2e_jmean renders, against the JAX chain's run of
# the same stages (experiments/e2e_jmean/REPORT.md:11-18 and :24-28).
# Limits, fixed before the first run on the card:
# * raw float32, the dataset within 0.005 and each sequence within 0.01
#   (tests/test_torch_jmean.py's limits: the card's cv2 encodes the JPEGs,
#   and the report rounds to 4 digits);
# * bfloat16 against float32 on the card, raw and the ensemble's 4-crop
#   mean at shift +1: dataset IoU and MAE within 1e-3 each (the report's
#   own reading is +0.0001 IoU). Controls: the raw run with the central crop
#   skipped, the ensemble with every member at crop 1.0, each of which
#   must exceed one of the two;
# * the soft score within 0.01; the forward-propagated running average
#   within 0.03 (the card's cv2 4.13.0 remaps with 1/32-pixel fixed-point
#   weights: 1.18e-2 on PWC flows); the CRF at the working and at the
#   original resolution within 0.02.
JMEAN_REPORT = {"raw_fp32": 0.6984, "soft_score": 0.6558, "propagated_f": 0.4431,
                "post_crf": 0.6953, "post_crf_original": 0.5471}
JMEAN_TOL = {"raw_fp32": 0.005, "soft_score": 0.01, "propagated_f": 0.03,
             "post_crf": 0.02, "post_crf_original": 0.02}
JMEAN_SEQUENCE_IOU = {"pan_a": 0.6537, "zoom_b": 0.7459, "drift_c": 0.7278,
                      "shear_d": 0.7367, "wobble_e": 0.6276}
JMEAN_SEQUENCE_TOL = 0.01
JMEAN_BF16_IOU_TOL = JMEAN_BF16_MAE_TOL = 1e-3
# The post stages against the JAX chain with the same PWC backend
# (weights_torch/jmean_pwc_backend_jax_cpu.md; the report above holds
# pyflow's). The port's chain on the same CPU reads within 3e-5 of it at
# every stage (soft score equal, propagated_f 3.7e-6, CRF 8.7e-6 and
# 8.2e-8, per sequence at most 2.9e-5; PERF.md section 6), so the
# limits are what the card changes, fixed before the first card run: the
# card's cv2 encodes the rendered JPEGs, which moves the raw dataset IoU
# within 0.005 and each sequence's within 0.01 (the limits above), and
# the soft score and the CRFs average the same frames: 0.005 on the
# dataset, 0.01 per sequence; propagated_f also carries the card's
# fixed-point remap (1.18e-2 in the running averages' values on PWC
# flows), which moves the pixels near the 0.1 threshold: 0.01.
JMEAN_PWC_JAX = {"soft_score": 0.6557555357609366, "propagated_f": 0.41774543542602866,
                 "post_crf": 0.692948970446984, "post_crf_original": 0.5430558410783609}
JMEAN_PWC_JAX_SEQUENCE = {
    "soft_score": {"pan_a": 0.6385495386438483, "zoom_b": 0.6915392575813871,
                   "drift_c": 0.6018204622966665, "shear_d": 0.6115001026481935,
                   "wobble_e": 0.7353683176345873},
    "post_crf": {"pan_a": 0.7302964777054376, "zoom_b": 0.6602165386931313,
                 "drift_c": 0.7516340708988549, "shear_d": 0.725306782291763,
                 "wobble_e": 0.5972909909937993}}
JMEAN_PWC_TOL = {"soft_score": 0.005, "propagated_f": 0.01, "post_crf": 0.005,
                 "post_crf_original": 0.005}
JMEAN_PWC_SEQUENCE_TOL = 0.01


def jmean_bf16(what: str, fp32: dict, bf16: dict, control: dict, misses: list) -> None:
    """Hold `bf16`'s dataset IoU and MAE to `fp32`'s, and see that the
    limits flag `control`; appends what misses to `misses`."""
    diffs = {name: (abs(r["dataset_iou"] - fp32["dataset_iou"]),
                    abs(r["dataset_mae"] - fp32["dataset_mae"]))
             for name, r in (("bfloat16", bf16), ("control", control))}
    (d_iou, d_mae), (c_iou, c_mae) = diffs["bfloat16"], diffs["control"]
    log(f"jmean: {what} bfloat16 vs float32 (float32 IoU {fp32['dataset_iou']}, MAE "
        f"{fp32['dataset_mae']}): abs diff IoU {d_iou} (tol {JMEAN_BF16_IOU_TOL}), MAE {d_mae} "
        f"(tol {JMEAN_BF16_MAE_TOL}); control: IoU {c_iou}, MAE {c_mae}")
    if not (d_iou <= JMEAN_BF16_IOU_TOL and d_mae <= JMEAN_BF16_MAE_TOL):
        misses.append(f"{what} bfloat16 differs from float32 by IoU {d_iou}, MAE {d_mae}")
    if c_iou <= JMEAN_BF16_IOU_TOL and c_mae <= JMEAN_BF16_MAE_TOL:
        misses.append(f"{what}: the bfloat16 limits do not flag the control")


def jmean_extra_runs(out: str, ckpt: str, res: dict, misses: list) -> None:
    """Off the chain: the raw control, the ensemble at shift +1 in bfloat16
    and its control, and each kernel against its plain version on one raw
    batch's inputs in both dtypes."""
    from unsupervised_detection_tpu_torch import e2e_jmean, parse_flags, test_generator
    from unsupervised_detection_tpu_torch import test_generator_ensemble
    from unsupervised_detection_tpu_torch.eval import TEST_CROPS
    from unsupervised_detection_tpu_torch.eval import ensemble as ensemble_module
    from unsupervised_detection_tpu_torch.eval.evaluator import build_test_pipeline
    from unsupervised_detection_tpu_torch.train.checkpoint import load_eval_checkpoint

    frames = len(e2e_jmean.SEQS) * e2e_jmean.FRAMES
    bf16_flags = e2e_jmean.common_flags(out, ckpt, "bfloat16")
    control, _ = run_captured(test_generator.main, bf16_flags + ["--test_crop=1.0"],
                              prefix="jmean: raw control: ")
    jmean_bf16("raw", res["raw"]["float32"], res["raw"]["bfloat16"], control, misses)

    ens_flags = bf16_flags + [f"--batch_size={e2e_jmean.BUFFER_BATCH}"]
    ens16, _ = run_captured(test_generator_ensemble.main, ens_flags,
                            prefix="jmean: ensemble bfloat16 shift 1: ")
    ensemble_module.TEST_CROPS = [1.0] * len(TEST_CROPS)
    try:
        ens_control, _ = run_captured(test_generator_ensemble.main, ens_flags,
                                      prefix="jmean: ensemble control: ")
    finally:
        ensemble_module.TEST_CROPS = TEST_CROPS
    if not ens16["frames"] == ens_control["frames"] == frames:
        raise AssertionError(f"jmean: bfloat16 ensembles over {ens16['frames']} and "
                             f"{ens_control['frames']} frames, expected {frames}")
    jmean_bf16("ensemble shift 1", res["buffer"]["1"], ens16, ens_control, misses)

    for dn in ("float32", "bfloat16"):
        cfg = parse_flags(e2e_jmean.common_flags(out, ckpt, dn))
        ev = Evaluator(cfg, device="cuda")
        ev.load_state_dicts(*load_eval_checkpoint(ckpt, cfg.pwc_search_range))
        first = next(iter(build_test_pipeline(cfg)))
        check_step_kernels(lambda: ev.infer_metrics(*ev.device_batch(first)),
                           f"jmean raw batch {cfg.batch_size}")


# scan_propagate, the propagation recurrence on the card (postproc/
# propagate.py): the chain's soft-score masks of its first sequence (T = 24)
# with the PWC backend's flows between its frames, at the chain's 192x384
# and resized (cv2, bilinear) to DAVIS' 480x854. Held: the card against
# the same call on CPU tensors (warp_plain) within 1e-6 (the kernel repeats
# warp_plain's arithmetic and max is exact: bit-equal expected); against
# the host loop `propagate_masks` within JAX's own 2e-5
# (tests/test_postproc.py) on the flows rounded to 1/32 px (the card's cv2
# remaps in 1/32-px fixed point, exact on them), zero on a 4-px border and
# wherever a sample would leave the frame (the warp clamps there, cv2
# fills zeros); 2(T-1) warp launches per call, no other kernel.
SCAN_SIZES = ((192, 384), (480, 854))
SCAN_TOL, SCAN_HOST_TOL = 1e-6, 2e-5


def scan_flows(images, flow_fn):
    """(T-1, H, W, 2) float32 (u, v) flows from frame t's grid into frame
    t-1, the host loop's pairs."""
    import numpy as np

    return np.stack([np.stack(flow_fn(images[t], images[t - 1]), axis=-1)
                     for t in range(1, len(images))]).astype(np.float32)


def host_safe_flows(flows):
    """`flows` in multiples of 1/32 px, zero on a 4-px border and where the
    sample would leave the frame."""
    import numpy as np

    q = np.round(flows * 32.0) / 32.0
    _, h, w, _ = q.shape
    x = np.arange(w)[None, None, :] + q[..., 0]
    y = np.arange(h)[None, :, None] + q[..., 1]
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    q[~inside] = 0.0
    q[:, :4] = q[:, -4:] = 0.0
    q[:, :, :4] = q[:, :, -4:] = 0.0
    return q


def jmean_scan(out: str, report: dict) -> dict:
    """scan_propagate on the chain's masks and PWC flows at SCAN_SIZES:
    card against CPU, against the host loop, launches; ms per call (CUDA
    events) and the warp's device us per launch (torch.profiler)."""
    import cv2
    import numpy as np
    import scipy.io as sio

    from unsupervised_detection_tpu_torch import e2e_jmean
    from unsupervised_detection_tpu_torch.postproc import propagate

    seq = e2e_jmean.SEQS[0]
    mats = [sio.loadmat(os.path.join(out, "soft", seq, f"result_{k}.mat"))
            for k in range(1, e2e_jmean.FRAMES + 1)]
    masks0 = [np.squeeze(m["pred_mask"]).astype(np.float32) for m in mats]
    images0 = [np.squeeze(m["img1"]).astype(np.float64) / 255.0 for m in mats]
    flow_fn = propagate.pwc_flow_fn(e2e_jmean.CKPT_FILE, search_range=e2e_jmean.SEARCH_RANGE,
                                    device="cuda")
    t = len(masks0)
    rows, total = {}, dict.fromkeys(launch_counts(), 0)
    for h, w in SCAN_SIZES:
        masks = [cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR) for m in masks0]
        images = [cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR) for im in images0]
        flows = scan_flows(images, flow_fn)
        m_cpu, f_cpu = torch.from_numpy(np.stack(masks)), torch.from_numpy(flows)
        m_card, f_card = m_cpu.cuda(), f_cpu.cuda()
        reset_counts()
        got = propagate.scan_propagate(m_card, f_card)
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, n in counts.items():
            total[k] += n
        err = float((got.cpu() - propagate.scan_propagate(m_cpu, f_cpu)).abs().max())
        safe = host_safe_flows(flows)
        steps = iter(safe)
        host = propagate.propagate_masks(masks, images, lambda a, b: tuple(
            c.astype(np.float64) for c in np.moveaxis(next(steps), -1, 0)))
        scan_safe = propagate.scan_propagate(m_card, torch.from_numpy(safe).cuda()).cpu()
        host_err = float(np.abs(scan_safe.numpy() - np.stack(host)).max())
        ms = time_cuda(propagate.scan_propagate, m_card, f_card, iters=5, warmup=1, repeats=3)
        _, _, per_kernel = profile_window(lambda: propagate.scan_propagate(m_card, f_card), 1)
        us, n = [sum(v[i] for k, v in per_kernel.items() if KERNEL_SYMBOLS["warp"] in k
                     and "backward" not in k) for i in (0, 1)]
        bound, _ = warp_bound(1, h, w, 1, torch.float32)
        row = {"launches": counts, "card_vs_cpu": err, "vs_host": host_err, "ms_per_call": ms,
               "warp_device_us_per_launch": us / max(n, 1), "warp_bound_us": bound * 1e3,
               "warp_kernels_profiled": n, "flow_abs_max": float(np.abs(flows).max()),
               "zeroed_share": float((safe == 0).all(-1).mean())}
        log(f"jmean: scan_propagate {seq} T={t} at {h}x{w}: launches {json.dumps(counts)} "
            f"(expected warp {2 * (t - 1)}, no other); card vs CPU max abs err {err} (tol "
            f"{SCAN_TOL}); vs the host loop on 1/32-px flows (zero on {row['zeroed_share']:.4f} "
            f"of the pixels) {host_err} (tol {SCAN_HOST_TOL}); {ms:.3f} ms per call (CUDA "
            f"events), the warp {row['warp_device_us_per_launch']:.2f} us per launch on the "
            f"card ({n} profiled) against its byte bound {row['warp_bound_us']:.3f} us "
            f"[{card_line()}]")
        want = {**dict.fromkeys(counts, 0), "warp": 2 * (t - 1)}
        if counts != want or not err <= SCAN_TOL or not host_err <= SCAN_HOST_TOL:
            raise AssertionError(f"jmean: scan_propagate at {h}x{w}: launches {counts}, "
                                 f"card vs CPU {err}, vs host {host_err}")
        rows[f"{h}x{w}"] = row
    report["launches_scan"] = total
    return rows


def jmean_trace(out: str, ckpt: str) -> dict:
    """utils/profiling's `trace` around one flagship forward on the chain's
    first raw batch (infer_metrics, float32), `sync` on its metrics; the
    trace file's kernel names must include the cost volume's and the
    warp's."""
    import glob
    import tempfile

    from unsupervised_detection_tpu_torch import e2e_jmean, parse_flags
    from unsupervised_detection_tpu_torch.eval.evaluator import build_test_pipeline
    from unsupervised_detection_tpu_torch.train.checkpoint import load_eval_checkpoint
    from unsupervised_detection_tpu_torch.utils.profiling import sync, trace

    cfg = parse_flags(e2e_jmean.common_flags(out, ckpt, "float32"))
    ev = Evaluator(cfg, device="cuda")
    ev.load_state_dicts(*load_eval_checkpoint(ckpt, cfg.pwc_search_range))
    batch = ev.device_batch(next(iter(build_test_pipeline(cfg))))
    ev.infer_metrics(*batch)
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            metrics = ev.infer_metrics(*batch)
            sync(metrics)
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        with open(files[0]) as fh:
            events = json.load(fh)["traceEvents"]
        size = os.path.getsize(files[0])
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {k: sorted(n for n in names if KERNEL_SYMBOLS[k] in n and "backward" not in n)
             for k in ("cost_volume", "warp")}
    log(f"jmean: trace of one flagship forward: {len(files)} file(s), {size} bytes, "
        f"{len(names)} kernel names; the port's kernels {json.dumps(found)}")
    if len(files) != 1 or not all(found.values()):
        raise AssertionError(f"jmean: trace: files {files}, kernels {found}")
    return {"bytes": size, "kernels": found}


def phase_jmean(report: dict) -> None:
    """The flagship's committed weights through the end-to-end chain
    (`e2e_jmean.main`: render, raw in both dtypes, the ensemble buffer for
    four shifts, post-processing with the PWC backend and the native CRF,
    the report) on the card; every stage held to the JAX chain's report,
    bfloat16 to float32 with controls, launches per stage, the kernels on
    one raw batch."""
    import hashlib
    import tempfile

    from unsupervised_detection_tpu_torch import e2e_jmean
    from unsupervised_detection_tpu_torch.postproc import crf, propagate, soft_score

    ckpt = e2e_jmean.CKPT_FILE
    with open(ckpt, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    log(f"jmean: checkpoint {os.path.relpath(ckpt, e2e_jmean.REPO)} sha256 {digest}, "
        f"{os.path.getsize(ckpt)} bytes")
    frames = len(e2e_jmean.SEQS) * e2e_jmean.FRAMES
    timer = StageTimer()
    for name in ("render_dataset", "raw_stage", "buffer_stage", "post_stage"):
        timer.wrap(e2e_jmean, name)
    timer.wrap(soft_score, "buffer_to_soft_score")
    timer.wrap(propagate, "propagate_sequences")
    timer.wrap(crf, "run_crf")
    timer.wrap(crf, "run_crf_original_resolution")
    misses: list = []
    with tempfile.TemporaryDirectory() as out:
        # the main path: the chain's CLI, counts from 0
        reset_counts()
        t0 = time.perf_counter()
        try:
            res, _ = run_captured(e2e_jmean.main, [out], prefix="jmean: ")
            torch.cuda.synchronize()
        finally:
            timer.restore()
        wall = time.perf_counter() - t0
        # one forward per raw batch (two dtypes), per ensemble frame and
        # shift, and per propagated pair (two passes)
        pairs = 2 * len(e2e_jmean.SEQS) * (e2e_jmean.FRAMES - 1)
        forwards = {"raw_stage": 2 * frames // e2e_jmean.RAW_BATCH,
                    "buffer_stage": len(e2e_jmean.SHIFTS) * frames, "post_stage": pairs}
        for name, n in forwards.items():
            postproc_counts(name, n, counts=timer.launches[name], phase="jmean")
        total = postproc_counts("the chain", sum(forwards.values()), phase="jmean")
        report["launches_jmean"] = total

        for key, want in JMEAN_REPORT.items():
            got = res[key]
            log(f"jmean: {key} {got} (report {want}, tol {JMEAN_TOL[key]})")
            if got is None or not abs(got - want) <= JMEAN_TOL[key]:
                misses.append(f"{key} {got}, report {want} +- {JMEAN_TOL[key]}")
        per_seq = res["per_seq"]["raw_fp32"]
        log(f"jmean: raw_fp32 per sequence {json.dumps(per_seq)} (report "
            f"{json.dumps(JMEAN_SEQUENCE_IOU)}, tol {JMEAN_SEQUENCE_TOL})")
        if list(per_seq) != list(JMEAN_SEQUENCE_IOU):
            misses.append(f"raw_fp32 sequences {list(per_seq)}")
        for seq, want in JMEAN_SEQUENCE_IOU.items():
            if not abs(per_seq.get(seq, -1.0) - want) <= JMEAN_SEQUENCE_TOL:
                misses.append(f"raw_fp32 {seq} {per_seq.get(seq)}, report {want}")
        for key in ("soft_score", "post_crf"):
            log(f"jmean: {key} per sequence {json.dumps(res['per_seq'][key])} (reported)")
        for key, want in JMEAN_PWC_JAX.items():
            got = res[key]
            log(f"jmean: {key} {got} against the JAX chain's PWC backend {want}: "
                f"{got - want:+.3g} (tol {JMEAN_PWC_TOL[key]})")
            if not abs(got - want) <= JMEAN_PWC_TOL[key]:
                misses.append(f"{key} {got}, JAX PWC backend {want} +- {JMEAN_PWC_TOL[key]}")
        for key, seqs in JMEAN_PWC_JAX_SEQUENCE.items():
            got = res["per_seq"][key]
            diffs = {seq: got.get(seq, math.inf) - want for seq, want in seqs.items()}
            log(f"jmean: {key} per sequence against the JAX chain's PWC backend "
                f"{json.dumps(diffs)} (tol {JMEAN_PWC_SEQUENCE_TOL})")
            if set(got) != set(seqs) or not all(abs(d) <= JMEAN_PWC_SEQUENCE_TOL
                                                 for d in diffs.values()):
                misses.append(f"{key} per sequence {got}, JAX PWC backend {seqs}")

        jmean_extra_runs(out, ckpt, res, misses)
        report["jmean_scan"] = jmean_scan(out, report)
        report["jmean_trace"] = jmean_trace(out, ckpt)

    sec, stage_s = timer.seconds, res["seconds"]
    seconds = {"render": sec["render_dataset"], "raw_fp32": stage_s["raw_fp32"],
               "raw_bf16": stage_s["raw_bf16"], "buffer": sec["buffer_stage"],
               "soft_score": sec["buffer_to_soft_score"] - sec["propagate_sequences"],
               "propagation": sec["propagate_sequences"], "crf": sec["run_crf"],
               "crf_original": sec["run_crf_original_resolution"], "post": sec["post_stage"]}
    per_frame = {k: v / frames for k, v in seconds.items()}
    log(f"jmean: the chain {wall:.2f} s; seconds {json.dumps(seconds)}; seconds per frame "
        f"({frames} frames; the buffer's 4 shifts together) {json.dumps(per_frame)}; CRF "
        f"backend {crf.backend_name()} on {torch.get_num_threads()} host threads of "
        f"{os.cpu_count()} [{card_line()}]")
    if crf.backend_name() != "native":
        misses.append(f"the chain ran the {crf.backend_name()} CRF")
    if misses:
        raise AssertionError("jmean: " + "; ".join(misses))


# the recipe phase (recipe/): the recipe that made the flagship at its full
# sizes, float32 with TF32 off unless stated, the flagship's PWC (r=2).
# Scenes: draws on the CPU, rendered on the card and on the CPU; the same
# operations in float32 on both (bilinear upsample, affine fields, sin/cos
# for v3, the warp), so they agree to the last bits of a float32 op and a
# warp's taps: fixed at 1e-6 before the first call. The warp kernel
# against warp_plain on the render's own inputs: bit-equal (as phase
# kernels holds it). The diagnostic: region EPEs of the same draws, card
# against CPU, 1e-3 px (fixed before the first call: a mean over ~1e6
# pixels of errors that differ by the cost volume's ~1e-6 and cuDNN's
# last bits). Beside JAX's record of the same PWC
# (experiments/README.md:45-49: native, fullres, divisor; overall, inside,
# boundary, background), drawn from other keys, within RECIPE_DIAG_BAND:
# two draws differ by sqrt(2) standard deviations of one, and the band is
# 3 of those, from the standard deviation of the port's values over scene
# seeds 0-7 on the CPU (`recipe.flow_diag --seeds=0,1,2,3,4,5,6,7`, batch
# 16; PERF.md section 6). The range over the 8 seeds is too narrow:
# JAX's draw lies outside it for native background (1.35 against
# 0.98-1.25), yet the port reproduces JAX's record on JAX's draws
# (tests/test_torch_recipe.py).
# The game: 100 warm-start steps and 50 cycles per dtype at 192x384,
# batch 16, square 48, f=0.25, the flagship recipe's lever (EXP_POSTLOCK_LR
# 0.3); the first sub-step's 8 losses card against CPU on the same weights
# and inputs within 1e-4 relative (the train phase's limit; the reduction
# rates, 1 - a ratio near 1, relative to the ratios, k - value, as
# tests/test_torch_recipe.py holds them against JAX); the resume
# round trip (model-25 of the float32 run resumed to cycle 50 in a fresh
# game, cuDNN deterministic) bit-equal to the uninterrupted run. Recipe
# pretraining: 30 steps of scenes v2 at 128x192, batch 8, cosine, object
# weight 4, per dtype; EPE on a held-out v2 batch must fall.
RECIPE_SCENE_TOL = 1e-6
RECIPE_DIAG_TOL = 1e-3
RECIPE_LOSS_RTOL = 1e-4
RECIPE_RATE_TERMS = {"generator": 2, "red_rate": 1, "red_rate_compl": 1}
RECIPE_GAME = dict(cycles=50, batch=16, pretrain=100, f=0.25, height=192, width=384)
RECIPE_SAVE_EVERY = 25
RECIPE_PRETRAIN_STEPS, RECIPE_PRETRAIN_BATCH = 30, 8
RECIPE_PRETRAIN_HW = (128, 192)
JAX_DIAG = {"native": {"overall": 1.68, "inside": 4.22, "boundary": 7.97, "background": 1.35},
            "fullres": {"overall": 1.90, "inside": 3.38, "boundary": 7.78, "background": 1.74},
            "divisor": {"overall": 2.89, "inside": 7.69, "boundary": 8.39, "background": 2.59}}
RECIPE_DIAG_STD = {"native": {"overall": 0.164, "inside": 1.473, "boundary": 1.080,
                               "background": 0.100},
                    "fullres": {"overall": 0.073, "inside": 0.626, "boundary": 0.795,
                                "background": 0.057},
                    "divisor": {"overall": 0.064, "inside": 0.731, "boundary": 0.585,
                                "background": 0.071}}
RECIPE_DIAG_BAND = {p: {k: 3 * math.sqrt(2) * sd for k, sd in v.items()}
                    for p, v in RECIPE_DIAG_STD.items()}


def recipe_scenes(report: dict) -> dict:
    """Each generator's draws on the CPU, rendered on the card and on the
    CPU at its full size; one warp launch per card render, the warp kernel
    bit-equal to warp_plain on the render's inputs."""
    from unsupervised_detection_tpu_torch.recipe import scenes

    h, w = RECIPE_PRETRAIN_HW
    gens = {"game 192x384 batch 16": (lambda g: scenes.game_draws(g, 16, 192, 384, 48),
                                      lambda d, dev: scenes.render_game(d, 192, 384, 48, True,
                                                                        dev)),
            "v2 128x192 batch 8": (lambda g: scenes.v2_draws(g, 8, h, w),
                                   lambda d, dev: scenes.render_v2(d, h, w, device=dev)),
            "v3 128x192 batch 8": (lambda g: scenes.v2_draws(g, 8, h, w, deform_amp=6.0),
                                   lambda d, dev: scenes.render_v2(d, h, w, deform_amp=6.0,
                                                                   device=dev))}
    out = {}
    for i, (name, (draw, render)) in enumerate(gens.items()):
        draws = draw(torch.Generator().manual_seed(60 + i))
        reset_counts()
        card = render(draws, "cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
        t0 = time.perf_counter()
        for _ in range(5):
            render(draws, "cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        cpu = render(draws, "cpu")
        errs = [errors(c, g.cpu())[0] for c, g in zip(cpu[:-1], card[:-1])]
        masks_equal = bool(torch.equal(cpu[-1], card[-1].cpu()))
        img1, flow = card[0], card[2] * 80.0
        with torch.no_grad():
            kernel, plain = dense_image_warp(img1, -flow), warp_plain(img1, -flow)
        warp_equal = bool(torch.equal(kernel, plain))
        out[name] = {"max_abs_err": max(errs), "masks_equal": masks_equal,
                     "warp_bit_equal": warp_equal, "ms": ms, "launches": counts}
        log(f"recipe: scenes {name}: card vs CPU max abs err by output {errs} (tol "
            f"{RECIPE_SCENE_TOL}), masks equal {masks_equal}, warp kernel bit-equal to "
            f"warp_plain on the render's inputs {warp_equal}; launches {json.dumps(counts)}; "
            f"{ms:.3f} ms per batch (host clock, draws on the host excluded)")
        if not (max(errs) <= RECIPE_SCENE_TOL and masks_equal and warp_equal):
            raise AssertionError(f"recipe scenes {name}: {out[name]}")
        if counts != {**dict.fromkeys(counts, 0), "warp": 1}:
            raise AssertionError(f"recipe scenes {name}: launches {counts}, expected 1 warp")
        report["warp"]["max_abs_err"] = max(report["warp"]["max_abs_err"],
                                            float((kernel - plain).abs().max()))
    return out


def recipe_diag() -> dict:
    """The diagnostic's three paths at batch 16 on the card and on the CPU
    for the same draws (seed 999), held within RECIPE_DIAG_TOL, and beside
    JAX's record within RECIPE_DIAG_BAND; launches per path."""
    from unsupervised_detection_tpu_torch.e2e_jmean import CKPT_FILE
    from unsupervised_detection_tpu_torch.recipe import flow_diag

    quiet = [].append
    card_net = flow_diag.load_pwc(CKPT_FILE, "cuda")
    timer = StageTimer()
    timer.wrap(flow_diag, "estimate")
    timer.wrap(flow_diag, "path_inputs")
    reset_counts()
    t0 = time.perf_counter()
    try:
        card = flow_diag.diagnose(card_net, 16, flow_diag.VAL_SEED, "cuda", log=quiet)
        torch.cuda.synchronize()
    finally:
        timer.restore()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    cpu = flow_diag.diagnose(flow_diag.load_pwc(CKPT_FILE, "cpu"), 16, flow_diag.VAL_SEED, "cpu",
                             log=quiet)
    misses = []
    for path, regions in card.items():
        diffs = {k: abs(v - cpu[path][k]) for k, v in regions.items()}
        jax_gap = {k: regions[k] - JAX_DIAG[path][k] for k in JAX_DIAG[path]}
        log(f"recipe: diag {flow_diag.line(path, regions)}  seen {regions['seen']:.4f} | card vs "
            f"CPU {json.dumps(diffs)} (tol {RECIPE_DIAG_TOL}) | JAX's record (other draws) "
            f"{json.dumps(JAX_DIAG[path])}, card - JAX {json.dumps(jax_gap)}, band "
            f"{json.dumps(RECIPE_DIAG_BAND[path])}")
        if not all(d <= RECIPE_DIAG_TOL for d in diffs.values()):
            misses.append(f"{path} card vs CPU {diffs}")
        if not all(abs(g) <= RECIPE_DIAG_BAND[path][k] for k, g in jax_gap.items()):
            misses.append(f"{path} outside the band of JAX's record: {jax_gap}")
    per_path = {k: v / len(card) for k, v in counts.items()}
    log(f"recipe: diag launches {json.dumps(counts)} ({json.dumps(per_path)} per path: 1 render "
        f"warp and one PWC forward), {wall:.2f} s for 3 paths at batch 16 (renders "
        f"{timer.seconds['path_inputs']:.3f} s, PWC {timer.seconds['estimate']:.3f} s) "
        f"[{card_line()}]")
    if counts != {**dict.fromkeys(counts, 0), "cost_volume": 15, "warp": 15}:
        misses.append(f"diag launches {counts}")
    if misses:
        raise AssertionError("recipe diag: " + "; ".join(misses))
    return {"card": card, "cpu": cpu, "launches": counts, "seconds": wall}


class SubStepProbe:
    """Wraps Game.sub_step: the launch counts at every call (their
    differences are one sub-step with the next batch's inputs), and the
    weights and inputs of the first call with its losses."""

    def __init__(self):
        from unsupervised_detection_tpu_torch.recipe import game

        self.game_cls, self.orig = game.Game, game.Game.sub_step
        self.counts, self.first = [], None
        probe = self

        def sub_step(self, player, image, flow, lr_scale=1.0):
            probe.counts.append(launch_counts())
            if probe.first is None:
                probe.first = {"player": player, "image": image.cpu(), "flow": flow.cpu(),
                               "gen": {k: v.to("cpu", copy=True) for k, v in
                                       self.state.generator.state_dict().items()},
                               "rec": {k: v.to("cpu", copy=True) for k, v in
                                       self.state.recover.state_dict().items()}}
                losses = probe.orig(self, player, image, flow, lr_scale)
                probe.first["losses"] = {k: float(v) for k, v in losses.items()}
                return losses
            return probe.orig(self, player, image, flow, lr_scale)

        game.Game.sub_step = sub_step

    def restore(self):
        self.game_cls.sub_step = self.orig

    def per(self, n: int) -> dict:
        a, b = self.counts[0], self.counts[n]
        return {k: b[k] - a[k] for k in a}


def first_sub_step_rel(first: dict, cpu_game) -> dict:
    """The 8 losses of a `SubStepProbe`'s first sub-step against the same
    weights and inputs in `cpu_game`, float32: relative differences (the
    reduction rates relative to their ratios, k - value)."""
    cpu_game.state.generator.load_state_dict(first["gen"])
    cpu_game.state.recover.load_state_dict(first["rec"])
    with torch.no_grad(), precision_scope(torch.float32):
        want = {k: float(v) for k, v in cpu_game.objective.losses_from_flow(
            first["image"], first["flow"]).losses.items()}
    return {k: abs(first["losses"][k] - v) / max(RECIPE_RATE_TERMS.get(k, 0) - v
                                                 if k in RECIPE_RATE_TERMS else abs(v), 1e-30)
            for k, v in want.items()}


def recipe_game_run(dn: str, state_dir: str, env: dict):
    from unsupervised_detection_tpu_torch.e2e_jmean import CKPT_FILE
    from unsupervised_detection_tpu_torch.recipe import game

    g = RECIPE_GAME
    argv = [str(g["cycles"]), str(g["batch"]), str(g["pretrain"]), str(g["f"]), str(g["height"]),
            str(g["width"]), CKPT_FILE, state_dir, f"--dtype={dn}"]
    lines = []
    return game.main(argv, environ=env, log=lines.append), lines


def recipe_game(report: dict) -> dict:
    """The game per dtype: seconds per warm-start step and per cycle,
    launches per sub-step, per cycle and per run; the first sub-step's
    losses card against CPU; the resume round trip; model.best read by the
    evaluation loader; the kernels on one sub-step's inputs."""
    import shutil
    import tempfile

    from unsupervised_detection_tpu_torch.e2e_jmean import CKPT_FILE
    from unsupervised_detection_tpu_torch.recipe import game, scenes
    from unsupervised_detection_tpu_torch.train import checkpoint as ckpt
    from unsupervised_detection_tpu_torch.train.checkpoint import load_eval_checkpoint

    g = RECIPE_GAME
    env = {"EXP_SAVE_EVERY": str(RECIPE_SAVE_EVERY), "EXP_POSTLOCK_LR": "0.3"}
    forwards = g["pretrain"] + 4 * g["cycles"] + 1          # + the validation batch
    want = {**dict.fromkeys(launch_counts(), 0), "cost_volume": 5 * forwards,
            "warp": 5 * forwards}
    out, misses = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for dn in ("float32", "bfloat16"):
            probe = SubStepProbe()
            reset_counts()
            try:
                rec, lines = recipe_game_run(dn, os.path.join(tmp, dn), env)
                torch.cuda.synchronize()
            finally:
                probe.restore()
            counts = launch_counts()
            for line in lines:
                log(f"recipe: game {dn}: {line}")
            row = {"s_per_cycle": rec["seconds"]["cycles"] / g["cycles"],
                   "ms_per_warm_start_step": rec["seconds"]["pretrain"] / g["pretrain"] * 1e3,
                   "launches": counts, "per_sub_step": probe.per(1), "per_cycle": probe.per(4),
                   "epe": rec["epe"], "hist": rec["hist"], "first": probe.first}
            log(f"recipe: game {dn}: {row['s_per_cycle']:.4f} s per cycle (4 sub-steps, host "
                f"clock over {g['cycles']} cycles, validations included), "
                f"{row['ms_per_warm_start_step']:.3f} ms per warm-start step; launches "
                f"{json.dumps(counts)} (expected {json.dumps(want)}), per sub-step "
                f"{json.dumps(row['per_sub_step'])}, per cycle {json.dumps(row['per_cycle'])} "
                f"[{card_line()}]")
            if counts != want:
                misses.append(f"{dn} launches {counts}, expected {want}")
            if not all(math.isfinite(v) for v in probe.first["losses"].values()):
                misses.append(f"{dn} first sub-step losses {probe.first['losses']}")
            out[dn] = row
            out[dn]["game"] = rec["game"]

        # the first sub-step on the CPU: the same weights and inputs
        first = out["float32"]["first"]
        rel = first_sub_step_rel(first, game.Game(game.GameArgs(
            batch=g["batch"], height=g["height"], width=g["width"], device="cpu")))
        log(f"recipe: game first sub-step ({first['player']}) card vs CPU losses relative "
            f"{json.dumps(rel)} (tol {RECIPE_LOSS_RTOL})")
        if not all(r <= RECIPE_LOSS_RTOL for r in rel.values()):
            misses.append(f"first sub-step card vs CPU {rel}")

        # resume: model-25 of the float32 run, resumed to cycle 50 in a fresh game
        resumed_dir = os.path.join(tmp, "resumed")
        os.makedirs(resumed_dir)
        shutil.copy(os.path.join(tmp, "float32", f"model-{RECIPE_SAVE_EVERY}"), resumed_dir)
        reset_counts()
        rec, lines = recipe_game_run("float32", resumed_dir, env)
        torch.cuda.synchronize()
        resume_counts = launch_counts()
        whole, again = out["float32"]["game"].state, rec["game"].state
        same = {n: all(torch.equal(a, b) for a, b in zip(getattr(whole, n).state_dict().values(),
                                                         getattr(again, n).state_dict().values()))
                for n in ("generator", "recover")}
        for n in ("gen_opt", "rec_opt"):
            a, b = getattr(whole, n), getattr(again, n)
            same[n] = a.count == b.count and all(torch.equal(a.m[k], b.m[k]) and
                                                 torch.equal(a.v[k], b.v[k]) for k in a.m)
        same["rng"] = bool(torch.equal(whole.rng.get_state(), again.rng.get_state()))
        same["validations"] = rec["hist"] == [h for h in out["float32"]["hist"]
                                              if h[0] > RECIPE_SAVE_EVERY]
        log(f"recipe: game resume {lines[1]!r}: {json.dumps(same)} (bit-equal to the "
            f"uninterrupted run), {rec['seconds']['cycles']:.2f} s for "
            f"{rec['cycles_run']} cycles; launches {json.dumps(resume_counts)}")
        if not all(same.values()):
            misses.append(f"resume not bit-equal: {same}")

        # model.best: what test_generator's loader reads
        best_path = os.path.join(tmp, "float32", ckpt.BEST_NAME)
        gen_sd, pwc_sd = load_eval_checkpoint(best_path, 2)
        trees = ckpt.load_trees(best_path)
        flagship_pwc = load_eval_checkpoint(CKPT_FILE, 2)[1]
        pwc_same = all(torch.equal(pwc_sd[k], flagship_pwc[k]) for k in flagship_pwc)
        best = out["float32"]
        log(f"recipe: game model.best ({os.path.getsize(best_path)} bytes): loaded by "
            f"load_eval_checkpoint, {len(gen_sd)} generator tensors, PWC bit-equal to the "
            f"flagship's {pwc_same}, cycle {int(trees['cycle'])} best {float(trees['best']):.4f} "
            f"(the run's best IoU {max(h[1] for h in best['hist'][:-1]):.4f})")
        if not pwc_same or int(trees["cycle"]) not in [h[0] for h in best["hist"]]:
            misses.append("model.best")

        for dn in ("float32", "bfloat16"):
            gm = out[dn].pop("game")
            draws = scenes.game_draws(torch.Generator().manual_seed(70), g["batch"],
                                      g["height"], g["width"], gm.args.side)
            for name, err in check_step_kernels(lambda: gm.inputs(draws),
                                                f"recipe game inputs {dn}").items():
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    if misses:
        raise AssertionError("recipe game: " + "; ".join(misses))
    return out


def recipe_pretrain(report: dict) -> dict:
    """The PWC recipe v2 per dtype: ms per step (CUDA events at each step's
    start, after the first), launches (5 cost volume and its backward, 5
    warp with the render's, 4 warp backward per step), the EPE on a held-out
    v2 batch before and after; the kernels on one step's inputs."""
    from unsupervised_detection_tpu_torch.models import PWCNet
    from unsupervised_detection_tpu_torch.recipe import pretrain_pwc as recipe_pretrain_pwc
    from unsupervised_detection_tpu_torch.recipe import scenes
    from unsupervised_detection_tpu_torch.train import pretrain_pwc as pretrain_module
    from unsupervised_detection_tpu_torch.train.pretrain_pwc import pwc_loss

    h, w = RECIPE_PRETRAIN_HW
    n, b = RECIPE_PRETRAIN_STEPS, RECIPE_PRETRAIN_BATCH
    img1, img2, flow80, mask = scenes.v2_batch(torch.Generator().manual_seed(6), b, h, w,
                                               device="cuda")
    held = (img1, img2, flow80 * 80.0)
    want = {"cost_volume": 5 * n, "warp": 5 * n, "dynamic_copy": 0,
            "cost_volume_backward": 5 * n, "warp_backward": 4 * n}
    out, misses = {}, []
    orig_step = pretrain_module.PWCPretrainer.step
    for dn in ("float32", "bfloat16"):
        args = recipe_pretrain_pwc.parse_args([str(n), str(b), str(h), str(w), "", "", "2",
                                               f"--dtype={dn}"],
                                              environ={"PWC_LR_SCHEDULE": "cosine"})
        seen = {"events": [], "initial": None, "trainer": None}

        def step(self, *batch):
            if seen["initial"] is None:
                seen["initial"] = {k: v.clone() for k, v in self.net.state_dict().items()}
                seen["trainer"], seen["batch"] = self, batch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            seen["events"].append(ev)
            return orig_step(self, *batch)

        pretrain_module.PWCPretrainer.step = step
        reset_counts()
        try:
            net, epe = recipe_pretrain_pwc.run(args, log=[].append, verbose=False)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
        finally:
            pretrain_module.PWCPretrainer.step = orig_step
        counts = launch_counts()
        events = seen["events"] + [end]
        step_ms = [a.elapsed_time(c) for a, c in zip(events[1:-1], events[2:])]
        initial = PWCNet(search_range=2, dtype=net.dtype).to("cuda")
        initial.load_state_dict(seen["initial"])
        with torch.no_grad(), precision_scope(net.dtype):
            before = float(pwc_loss(initial, *held)[1])
            after = float(pwc_loss(net, *held)[1])
        row = {"ms_per_step": sum(step_ms) / len(step_ms), "launches": counts,
               "held_epe": (before, after), "final_train_epe": epe}
        log(f"recipe: pretrain {dn} v2 {h}x{w} batch {b}, {n} steps, cosine, object weight "
            f"{args.object_weight}: {row['ms_per_step']:.3f} ms per step (CUDA events, the "
            f"render of the next batch included, mean of {len(step_ms)} after the first); "
            f"launches {json.dumps(counts)} (expected {json.dumps(want)}); held-out EPE "
            f"{before:.4f} -> {after:.4f} px (must fall); final train EPE {epe:.4f} "
            f"[{card_line()}]")
        if counts != want:
            misses.append(f"{dn} launches {counts}")
        if not (math.isfinite(after) and after < before and all_finite(net)):
            misses.append(f"{dn} held-out EPE {before} -> {after}")
        trainer, batch = seen["trainer"], seen["batch"]
        for name, err in check_step_kernels(lambda: trainer.step(*batch),
                                            f"recipe pretrain step {dn}", backward=True).items():
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        out[dn] = row
    if misses:
        raise AssertionError("recipe pretrain: " + "; ".join(misses))
    return out


def phase_recipe(report: dict) -> None:
    """The recipe that made the flagship (recipe/): scenes, the region-EPE
    diagnostic, the game and the PWC recipe at full size on the card."""
    t = {}
    t0 = time.perf_counter()
    scenes_out = recipe_scenes(report)
    t["scenes"] = time.perf_counter() - t0
    diag = recipe_diag()
    t["diag"] = time.perf_counter() - t0 - sum(t.values())
    games = recipe_game(report)
    t["game"] = time.perf_counter() - t0 - sum(t.values())
    pre = recipe_pretrain(report)
    t["pretrain"] = time.perf_counter() - t0 - sum(t.values())
    # the main path's launches: the game in both dtypes, the diagnostic and
    # the recipe's pretraining in both dtypes (comparisons excluded)
    total = dict.fromkeys(launch_counts(), 0)
    for counts in ([games[dn]["launches"] for dn in games] + [diag["launches"]]
                   + [pre[dn]["launches"] for dn in pre]
                   + [s["launches"] for s in scenes_out.values()]):
        for k, v in counts.items():
            total[k] += v
    report["launches_recipe"] = total
    log(f"recipe: launches over the phase's card runs {json.dumps(total)}; seconds "
        f"{json.dumps(t)}")


# The game's instruments (recipe/synth.py, inspect_mask.py, game_stats.py).
# The synthetic game at the tool's batch 8 and 200 warm-start steps (64x128,
# fp32, f=0.25, cuDNN deterministic), cut from the tool's 400 cycles to 100:
# at 0.24 s per cycle alone and 0.42 within the whole script on an H100,
# the 400 took the phase past its 120 s budget and 200 used 94 s of it. The
# full run is weights_torch/synth_game_card_fp32.log; whether the cut run
# replays its first lines is printed. No PWC and no warp in
# losses_from_flow, so no kernel launch; the first sub-step's 8 losses card
# against CPU within the recipe phase's 1e-4. The inspector at its defaults
# (192x384, batch 16, the flagship's PWC at r=2) on the flagship and on the
# port's own detector, card against CPU: fp32 masks on the two differ by up
# to 3.37e-5 on real frames (PERF.md), so a pixel within that of 0.5 may
# flip; a flip moves a sample's IoU, area and in-gt by about 1 / its mask's
# pixels, its centroid by about the frame's size / its mask's pixels, and
# may split or join a component. The limits: IoU, area and in-gt within
# 1e-3, the centroid within 0.1 px, the components equal.
GAMETOOLS_SYNTH = dict(cycles=100, batch=8, pretrain=200)
SYNTH_CARD_LOG = "weights_torch/synth_game_card_fp32.log"
GAMETOOLS_INSPECT_HW_BATCH = (192, 384, 16)
INSPECT_TOL = 1e-3
INSPECT_CENTROID_TOL = 0.1
GAME_LOGS = ("weights_torch/game_card_fp32.log", "weights_torch/game_card_fp32_own_pwc.log",
             "experiments/game_state_sq96/log.txt", "experiments/game_state_v2/log.txt",
             "experiments/game_state_v2lr/log.txt", "experiments/game_state_v4/log.txt")


def gametools_synth(tmp: str) -> dict:
    """The synthetic game through its CLI's `main` at the tool's defaults:
    its console lines, s per cycle, the final IoU, launches (none); the
    first sub-step card against CPU; `game_stats` on its log."""
    from unsupervised_detection_tpu_torch.recipe import game_stats, synth

    g = GAMETOOLS_SYNTH
    argv = [str(g["cycles"]), str(g["batch"]), str(g["pretrain"])]
    lines = []
    probe = SubStepProbe()
    reset_counts()
    try:
        rec = synth.main(argv, log=lines.append)
        torch.cuda.synchronize()
    finally:
        probe.restore()
    counts = launch_counts()
    for line in lines:
        log(f"gametools: synth: {line}")
    first = probe.first
    rel = first_sub_step_rel(first, synth.make_game(synth.SynthArgs(*map(int, argv), "cpu")))
    s_per_cycle = rec["seconds"]["cycles"] / g["cycles"]
    final = rec["hist"][-1][1]
    log(f"gametools: synth {g['cycles']} cycles at batch {g['batch']} after {g['pretrain']} "
        f"warm-start steps: {s_per_cycle:.4f} s per cycle (4 sub-steps, host clock, "
        f"validations included), {rec['seconds']['pretrain'] / g['pretrain'] * 1e3:.3f} ms per "
        f"warm-start step; final IoU {final:.4f}; launches {json.dumps(counts)} (expected none: "
        f"no PWC, no warp); first sub-step ({first['player']}) card vs CPU losses relative "
        f"{json.dumps(rel)} (tol {RECIPE_LOSS_RTOL}) [{card_line()}]")
    path = os.path.join(tmp, "synth.log")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    # the cut run against the committed full run's first lines, elapsed
    # seconds aside: the same seeds and deterministic cuDNN replay it on the
    # same software, but another card or cuDNN may pick other algorithms
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, SYNTH_CARD_LOG)) as fh:
        full = [re.sub(r"  \(\d+s\)$", "", line.rstrip("\n")) for line in fh]
    ours = [re.sub(r"  \(\d+s\)$", "", line) for line in lines[:-1]]
    log(f"gametools: synth: the first {len(ours)} lines replay {SYNTH_CARD_LOG}'s: "
        f"{ours == full[:len(ours)]}")
    for line in game_stats.main([path], log=[].append):
        log(f"gametools: game_stats synth: {line}")
    misses = []
    if any(counts.values()):
        misses.append(f"launches {counts}")
    if not all(r <= RECIPE_LOSS_RTOL for r in rel.values()):
        misses.append(f"first sub-step card vs CPU {rel}")
    if not (math.isfinite(final) and len(rec["hist"]) == g["cycles"] // 25 + 2):
        misses.append(f"validations {rec['hist'][-3:]}")
    if misses:
        raise AssertionError("gametools synth: " + "; ".join(misses))
    return {"launches": counts, "s_per_cycle": s_per_cycle, "final_iou": final,
            "first_rel": rel}


def inspect_diff(a: float, b: float) -> float:
    """|a - b|; 0 where both are nan (an empty mask has no centroid)."""
    if math.isnan(a) and math.isnan(b):
        return 0.0
    d = abs(a - b)
    return math.inf if math.isnan(d) else d


def gametools_inspect(report: dict) -> dict:
    """The inspector on the flagship and on the port's own detector, card
    against CPU within the limits above; launches per inspection (the
    render's 1 warp, then the PWC forward's 5 cost-volume and 4 warp); the
    kernels on the flagship's inspection's inputs."""
    from unsupervised_detection_tpu_torch.e2e_jmean import CKPT_FILE
    from unsupervised_detection_tpu_torch.recipe import game as game_mod
    from unsupervised_detection_tpu_torch.recipe import inspect_mask

    h, w, b = GAMETOOLS_INSPECT_HW_BATCH
    own = os.path.join(os.path.dirname(CKPT_FILE), "game_card_fp32_best_gen.npz")
    detectors = {"flagship": CKPT_FILE, "port's own (cycle 1850)": own}
    zero = dict.fromkeys(launch_counts(), 0)
    out, misses = {}, []
    for name, game_ckpt in detectors.items():
        lines = []
        timer = StageTimer()
        timer.wrap(game_mod, "render_game")
        reset_counts()
        t0 = time.perf_counter()
        try:
            card = inspect_mask.inspect(game_ckpt, CKPT_FILE, h, w, b, "cuda", log=lines.append)
            torch.cuda.synchronize()
        finally:
            timer.restore()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        render = timer.launches["render_game"]
        pwc = {k: v - render[k] for k, v in counts.items()}
        cpu = inspect_mask.inspect(game_ckpt, CKPT_FILE, h, w, b, "cpu", log=[].append)
        for line in lines:
            log(f"gametools: inspect {name}: {line}")
        diffs = {k: max(inspect_diff(g[k], c[k]) for g, c in zip(card["rows"], cpu["rows"]))
                 for k in ("iou", "area", "in_gt", "dist")}
        ncomp_equal = [g["ncomp"] for g in card["rows"]] == [c["ncomp"] for c in cpu["rows"]]
        mask_err = float((card["mask"].cpu() - cpu["mask"]).abs().max())
        log(f"gametools: inspect {name}: card vs CPU max abs diff {json.dumps(diffs)} (tol "
            f"{INSPECT_TOL}, centroid {INSPECT_CENTROID_TOL} px), components equal "
            f"{ncomp_equal}, raw masks max abs err {mask_err:.3g}; launches {json.dumps(counts)}: "
            f"render {json.dumps(render)}, PWC forward {json.dumps(pwc)}; {wall:.2f} s per "
            f"inspection (host clock, loading included) [{card_line()}]")
        if not (all(diffs[k] <= INSPECT_TOL for k in ("iou", "area", "in_gt"))
                and diffs["dist"] <= INSPECT_CENTROID_TOL and ncomp_equal):
            misses.append(f"{name} card vs CPU {diffs}, components equal {ncomp_equal}")
        if render != {**zero, "warp": 1} or pwc != {**zero, "cost_volume": 5, "warp": 4}:
            misses.append(f"{name} launches: render {render}, PWC {pwc}")
        out[name] = {"rows": card["rows"], "mean_iou": card["mean_iou"], "launches": counts,
                     "seconds": wall, "diffs": diffs}
    for k, err in check_step_kernels(
            lambda: inspect_mask.inspect(CKPT_FILE, CKPT_FILE, h, w, b, "cuda", log=[].append),
            "gametools inspect inputs").items():
        report[k]["max_abs_err"] = max(report[k]["max_abs_err"], err)
    if misses:
        raise AssertionError("gametools inspect: " + "; ".join(misses))
    return out


# Where the card's float32 mask parts from the CPU's on the game's scenes:
# the inspector's inputs (the flagship at r=2, 192x384, batch 16, the
# validation draws), every layer of the forward recorded in the order it
# finishes on both sides (each side fed its own previous outputs); a layer
# parts where its output differs by more than LAYER_TOL of its largest
# |value|. The card runs with and without cuDNN's deterministic
# algorithms. A float64 run of the first such layer on the CPU, from the
# card's own input to it, against that layer in float32 on the card and on
# the CPU from the same input, says which side is off. For contrast, one
# card run on 8 frame pairs of the J-mean chain's JPEG video (pan_a) with
# the same nets.
LAYER_TOL = 1e-5
ARBITER_SAMPLES = 4      # the float64 arbiter's share of the batch
VIDEO_PAIRS = 8
CONV_TYPES = ("PWCConv", "GenConv", "GenDeconv", "ConvTranspose2D", "FlowEstimator",
              "ContextNet", "FeaturePyramid", "GeneratorNet")


def _tensors(x) -> list:
    """The tensors of x, a tensor or nested lists and tuples of them."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(item) for item in x)
    return x


def _cast(x, device, dtype):
    """Floating tensors in x (nested lists and tuples) on `device` in `dtype`."""
    if torch.is_tensor(x):
        return x.to(device, dtype if x.is_floating_point() else x.dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(item, device, dtype) for item in x)
    return x


class LayerTape:
    """Records, in the order they finish, every module of the game's PWC
    and generator, PWC's cost volume and warp calls (by level) and its
    final upsample, the flow's `resize_to_working` and standardization:
    {"name", "kind", "fn", "args", "out"}, the tensors on the CPU; the
    inputs ("args") only of the records named in `keep_args`."""

    def __init__(self, objective, keep_args=()):
        from unsupervised_detection_tpu_torch.models import pwcnet
        from unsupervised_detection_tpu_torch.train import objective as obj_mod

        self.records: list = []
        self.keep_args = set(keep_args)
        self._undo: list = []
        for prefix, net in (("pwc", objective.pwc), ("generator", objective.generator)):
            for name, module in net.named_modules():
                label = f"{prefix}.{name}" if name else prefix
                handle = module.register_forward_hook(self._hook(label))
                self._undo.append(handle.remove)
        for target, attr, labels in (
                (pwcnet, "cost_volume", [f"pwc.L{lvl}.cost_volume" for lvl in range(6, 1, -1)]),
                (pwcnet, "dense_image_warp", [f"pwc.L{lvl}.warp" for lvl in range(5, 1, -1)]),
                (pwcnet, "resize_bilinear", ["pwc.upsample"]),
                (objective, "resize_to_working", ["resize_to_working"]),
                (obj_mod, "standardize_flow", ["standardize_flow"])):
            self._patch(target, attr, labels)

    def _add(self, name, kind, fn, args, out):
        self.records.append({"name": name, "kind": kind, "fn": fn,
                             "args": _to_cpu(args) if name in self.keep_args else None,
                             "out": [t.detach().cpu() for t in _tensors(out)]})

    def _hook(self, label):
        def hook(module, args, out):
            self._add(label, type(module).__name__, module, args, out)
        return hook

    def _patch(self, target, attr, labels):
        fn = getattr(target, attr)
        own = attr in vars(target)
        calls = iter(labels)

        def recorded(*args):
            out = fn(*args)
            self._add(next(calls, attr), attr, fn, args, out)
            return out

        setattr(target, attr, recorded)
        self._undo.append(lambda: setattr(target, attr, fn) if own else delattr(target, attr))

    def close(self) -> list:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()
        return self.records


def tape_forward(objective, image_fn, device: str, deterministic: bool = False,
                 keep_args=()):
    """(records, mask) of one float32 forward (TF32 off) of `objective`'s
    PWC and generator on the frame pair `image_fn()` gives, on `device`;
    cuDNN's deterministic algorithms within it where asked."""
    from unsupervised_detection_tpu_torch.recipe.game import deterministic_cudnn

    img1, img2 = (t.to(device) for t in image_fn())
    scope = deterministic_cudnn() if deterministic else contextlib.nullcontext()
    tape = LayerTape(objective, keep_args)
    try:
        with scope, torch.no_grad(), precision_scope(torch.float32):
            flow = objective.compute_flow(img1, img2)
            image, flow = objective.resize_to_working(img1, flow)
            mask = objective.generate_mask(image, flow)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        records = tape.close()
    return records, mask.cpu()


def compare_tapes(card: list, cpu: list) -> list:
    """Per record: max abs difference of the outputs and that over the
    CPU output's largest |value| (the largest over a record's tensors)."""
    if [r["name"] for r in card] != [r["name"] for r in cpu]:
        raise AssertionError("layer tapes: the card and the CPU ran other layers")
    rows = []
    for a, b in zip(card, cpu):
        diff = rel = top = 0.0
        for x, y in zip(a["out"], b["out"]):
            d = float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
            t = float(y.float().abs().max()) if y.numel() else 0.0
            diff, top = max(diff, d), max(top, t)
            rel = max(rel, d / t if t > 0 else (0.0 if d == 0 else math.inf))
        rows.append({"name": a["name"], "kind": a["kind"], "abs": diff, "rel": rel, "max": top})
    return rows


def arbiter(record: dict, device: str = "cuda") -> dict:
    """The record's layer once more on its own (card) input, its first
    ARBITER_SAMPLES samples: in float32 on `device` (the card) and on the
    CPU and in float64 on the CPU; each float32 output's max abs
    difference from the float64 one, and the kernels the card ran
    (torch.profiler) where the layer is a convolution or a net."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(device, dtype):
        fn = record["fn"]
        if isinstance(fn, torch.nn.Module):
            fn = copy.deepcopy(fn).to(device)
            for m in fn.modules():          # a net's compute dtype (PWCNet, GeneratorNet)
                if isinstance(getattr(m, "dtype", None), torch.dtype):
                    m.dtype = dtype
        with torch.no_grad(), precision_scope(torch.float32):
            args = [a[:ARBITER_SAMPLES] if torch.is_tensor(a) else a for a in record["args"]]
            return _tensors(fn(*_cast(args, device, dtype)))

    # the resizes compute in float32 whatever the input: then the arbiter
    # has no float64 value; the nets compute in float64 and round their
    # output to float32 last (PWC's flow, the mask's softmax)
    exact = record["kind"] not in ("resize_bilinear", "resize_to_working")
    want = [t.double() for t in run("cpu", torch.float64)]
    activity = ProfilerActivity.CUDA if device == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        card = [t.double().cpu() for t in run(device, torch.float32)]
    kernels = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
    cpu = [t.double() for t in run("cpu", torch.float32)]

    def off(got):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    e_card, e_cpu = off(card), off(cpu)
    return {"card_vs_f64": e_card, "cpu_vs_f64": e_cpu, "f64_max": max(
                float(w.abs().max()) for w in want), "float64": exact,
            "off": "card" if e_card > e_cpu else "cpu" if e_cpu > e_card else "neither",
            "card_kernels": kernels if record["kind"] in CONV_TYPES else None}


def softmax_arbiter(logits: torch.Tensor) -> dict:
    """The generator's last step, softmax(logits / 10) channel 0, on the
    card's logits in float32 on the card and on the CPU against float64:
    each one's max abs difference."""
    def head(x):
        return torch.softmax(x / 10.0, dim=1)[:, 0]

    want = head(logits.double())
    return {k: float((head(logits.to(dev)).double().cpu() - want).abs().max())
            for k, dev in (("card_vs_f64", "cuda"), ("cpu_vs_f64", "cpu"))}


def jmean_pairs(root: str, batch: int):
    """`batch` consecutive frame pairs of the J-mean chain's first
    sequence, read from its JPEGs as the readers do (RGB, x/255 - 0.5)."""
    import cv2
    import numpy as np

    from unsupervised_detection_tpu_torch import e2e_jmean

    e2e_jmean.render_dataset(root)
    seq_dir = os.path.join(root, "JPEGImages/480p", e2e_jmean.SEQS[0])
    frames = [cv2.cvtColor(cv2.imread(os.path.join(seq_dir, f)), cv2.COLOR_BGR2RGB)
              for f in sorted(os.listdir(seq_dir))[:batch + 1]]
    x = np.stack(frames).astype(np.float32) / 255.0 - 0.5
    return torch.from_numpy(x[:-1]), torch.from_numpy(x[1:])


def gametools_layers() -> dict:
    """The layer tapes of the inspector's forward, card against CPU, with
    and without cuDNN's deterministic algorithms, the first layer that
    parts and its float64 arbiter; the same on the J-mean chain's frames
    without the deterministic algorithms."""
    import tempfile

    from unsupervised_detection_tpu_torch.e2e_jmean import CKPT_FILE
    from unsupervised_detection_tpu_torch.recipe import inspect_mask
    from unsupervised_detection_tpu_torch.recipe.game import VAL_SEED, Game, GameArgs
    from unsupervised_detection_tpu_torch.recipe.scenes import game_draws, render_game

    h, w, b = GAMETOOLS_INSPECT_HW_BATCH
    games = {}
    for device in ("cuda", "cpu"):
        games[device] = Game(GameArgs(batch=b, height=h, width=w, pwc_ckpt=CKPT_FILE,
                                      device=device))
        inspect_mask.load_generator(CKPT_FILE, games[device].state.generator)
    draws = game_draws(torch.Generator().manual_seed(VAL_SEED), b, h, w,
                       games["cuda"].args.side)
    # the card's render on both sides (the card's and the CPU's agree to 2.98e-8)
    scenes = render_game(draws, h, w, games["cuda"].args.side, with_pairs=True, device="cuda")
    pairs = {"game scenes": lambda: scenes[:2]}
    with tempfile.TemporaryDirectory() as tmp:
        video = jmean_pairs(tmp, VIDEO_PAIRS)
    pairs["J-mean video pan_a"] = lambda: video
    out = {}
    for what, image_fn in pairs.items():
        t0 = time.perf_counter()
        cpu, cpu_mask = tape_forward(games["cpu"].objective, image_fn, "cpu")
        log(f"gametools: layers {what}: the CPU's tape {time.perf_counter() - t0:.2f} s")
        runs = (False, True) if what == "game scenes" else (False,)
        for det in runs:
            label = f"{what}, cuDNN {'deterministic' if det else 'default'}"
            card, card_mask = tape_forward(games["cuda"].objective, image_fn, "cuda", det)
            rows = compare_tapes(card, cpu)
            first = next((i for i, r in enumerate(rows) if r["rel"] > LAYER_TOL), None)
            for i, r in enumerate(rows):
                if r["kind"] != "PWCConv" or i == first:
                    log(f"gametools: layers {label}: {r['name']} ({r['kind']}) max abs diff "
                        f"{r['abs']:.3g}, over its largest |value| {r['max']:.3g}: "
                        f"{r['rel']:.3g}{'  <- first above ' + str(LAYER_TOL) if i == first else ''}")
            names = [r["name"] for r in rows]
            flow_in = card[names.index("resize_to_working")]["out"][1]
            std = flow_in.std(dim=(1, 2), unbiased=False)
            row = {"mask_err": float((card_mask - cpu_mask).abs().max()),
                   "first": rows[first] if first is not None else None,
                   "flow_std_min_max": [float(std.min()), float(std.max())],
                   "logits": rows[names.index("generator.conv17")],
                   "softmax": softmax_arbiter(card[names.index("generator.conv17")]["out"][0])}
            if first is not None:
                again, _ = tape_forward(games["cuda"].objective, image_fn, "cuda", det,
                                        keep_args={rows[first]["name"]})
                row["arbiter"] = arbiter(again[first])
            log(f"gametools: layers {label}: mask max abs err {row['mask_err']:.3g}; the flow "
                f"/ 80's per-sample std {row['flow_std_min_max']}; the logits (conv17) "
                f"{json.dumps(row['logits'])}; the softmax(logits / 10) step alone on the card's "
                f"logits against float64 {json.dumps(row['softmax'])}; first layer above "
                f"{LAYER_TOL}: {json.dumps(row['first'])}; float64 arbiter from the card's input: "
                f"{json.dumps(row.get('arbiter'))}; {time.perf_counter() - t0:.2f} s so far "
                f"[{card_line()}]")
            out[label] = row
    return out


def gametools_stats() -> None:
    """`game_stats` on the port's two game logs and the JAX arms' four."""
    from unsupervised_detection_tpu_torch.recipe import game_stats

    root = os.path.dirname(os.path.abspath(__file__))
    for rel in GAME_LOGS:
        for line in game_stats.main([os.path.join(root, rel)], log=[].append):
            log(f"gametools: game_stats {rel}: {line}")


def phase_gametools(report: dict) -> None:
    """The game's instruments on the card: the synthetic game, the mask
    inspector on two detectors, the game-log summary."""
    import tempfile

    t = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        synth_out = gametools_synth(tmp)
    t["synth"] = time.perf_counter() - t0
    inspected = gametools_inspect(report)
    t["inspect"] = time.perf_counter() - t0 - sum(t.values())
    report["gametools_layers"] = gametools_layers()
    t["layers"] = time.perf_counter() - t0 - sum(t.values())
    gametools_stats()
    t["stats"] = time.perf_counter() - t0 - sum(t.values())
    total = dict(synth_out["launches"])
    for row in inspected.values():
        for k, v in row["launches"].items():
            total[k] += v
    report["launches_gametools"] = total
    log(f"gametools: launches over the phase's card runs {json.dumps(total)}; seconds "
        f"{json.dumps(t)}")


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


# the mesh phase: the train phase's sizes (r=2), the learner at batch 16 and
# recover pretraining at batch 8 (global batches); a mesh against one
# process within tests/test_torch_mesh.py's limits (the JAX package's own
# mesh equivalence, tests/test_train_step.py:140-146): the losses, and the
# parameters after the step wherever the gradient fixes them; the applied
# gradients within TRAIN_GRAD_REL of the net's largest, the train phase's
# limit for two computations on the card. A rank's 8 rows and one
# process's 16 run cuDNN convolutions chosen per batch size, and two
# processes on one card differ in the last bits even at one batch size, so
# a gradient differs in its last bits; TF1 Adam's first step moves an element by
# lr * g / (|g| + e), e = eps / sqrt(1 - b2) = 3.16e-7, so an element whose
# |g| is near e moves by a different share of lr on the two sides. Above
# MESH_ADAM_FLOOR = 100 e a gradient error d moves an element by at most
# lr * e * d / (|g| - d)^2 < 1e-6 * lr * d / e: far inside the limits.
# Below it the elements beyond the limits may number at most
# MESH_UNDER_FLOOR_SHARE of the elements, each off by at most lr: a first
# step moves an element by less than lr, so a larger difference needs
# steps of opposite sign.
MESH_BATCH, MESH_PRETRAIN_BATCH = 16, 8
MESH_RTOL, MESH_ATOL = 2e-5, 2e-6
MESH_ADAM_FLOOR = 100 * 1e-8 / math.sqrt(1 - 0.999)
MESH_UNDER_FLOOR_SHARE = 1e-4
MESH_SHAPES = ((2, 1), (1, 2))
# ranks sharing one card each take at most this share of it. cuDNN's
# deterministic plan is the first whose workspace can be allocated, and a
# rank's caching allocator keeps what it took, so without a share the
# first rank to grow decides which plans the other gets, and their last
# bits differ from run to run
MESH_SHARED_CARD_SHARE = 0.45
MESH_RANK_TIMEOUT = 300.0    # s; the 2 ranks take ~30 s on one H100


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(rank: int, world: int, local_rank: int, port: int):
    """torchrun's variables for one rank of a world on this host, as
    `mesh_from_env` reads them; the previous values come back on exit."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_frames(batch: int, device) -> tuple:
    """The first `recover_frames` pair, its first `batch` rows, on `device`."""
    frames = next(recover_frames(1))
    return tuple(torch.from_numpy(frames[k][:batch]).to(device) for k in ("img1", "img2"))


def mesh_steps(mesh, weights: dict, device, timed: bool = False) -> dict:
    """A generator and a recover step at MESH_BATCH from `weights`, on this
    rank's rows of one global batch with the global batch's draws: the 8
    losses, the applied gradients and both nets' parameters after (CPU
    copies). With `timed`, one more step of each timed with CUDA events, and
    one flat reduction of each net's gradients (and the 8 losses) timed
    alone on the host clock (median of 5); on a model axis also the flat
    broadcast over the model group that the reduction ends with."""
    import statistics

    import torch.distributed as dist

    from unsupervised_detection_tpu_torch.ops.augment import sample_augment

    cfg = Config(batch_size=MESH_BATCH, **TRAIN_SIZES)
    learner, state = make_learner(cfg, device, weights, mesh)
    img1, img2 = (mesh.shard(t) for t in mesh_frames(MESH_BATCH, device))
    gen = torch.Generator().manual_seed(5)
    out = {}
    for name in ("generator_step", "recover_step"):
        draws = sample_augment(gen, MESH_BATCH, cfg.reader_height, cfg.reader_width,
                               cfg.train_crop)
        state, losses, grads = getattr(learner, name)(state, img1, img2, draws=draws)
        out[name] = {"losses": {k: float(v) for k, v in losses.items()},
                     "grads": [g.detach().cpu().clone() for g in grads]}
    out["params"] = net_params(state)
    if not timed:
        return out
    ms = {}
    for name in ("generator_step", "recover_step"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, losses, grads = getattr(learner, name)(state, img1, img2)
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end)
        flat = [g.clone() for g in grads] + [v.clone() for v in losses.values()]
        whole = torch.cat([t.reshape(-1).to(torch.float32) for t in flat])
        calls = {"_reduction": lambda: mesh.sum_data(flat)}
        if mesh.n_model > 1:
            calls["_broadcast"] = lambda: dist.broadcast(
                whole, src=mesh.data_index * mesh.n_model, group=mesh.model_group)
        for suffix, call in calls.items():
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name.replace("_step", suffix)] = statistics.median(times)
    out["ms"] = ms
    return out


def mesh_nets(cfg: Config, entry, device, weights: dict, mesh):
    """`entry` (Evaluator or EnsembleEvaluator) on `device` and `mesh` with
    the generator and PWC of `weights`."""
    from unsupervised_detection_tpu_torch.convert import from_jax_params

    ev = entry(cfg, device, mesh)
    ev.load_state_dicts(*from_jax_params(weights["gen_params"], weights["gen_stats"],
                                         weights["pwc_params"]))
    return ev


def mesh_mask(mesh, weights: dict, device) -> torch.Tensor:
    """Evaluator.infer's masks of the global batch at MESH_BATCH (this
    rank's rows), on the CPU."""
    cfg = Config(batch_size=MESH_BATCH, **TRAIN_SIZES)
    ev = mesh_nets(cfg, Evaluator, device, weights, mesh)
    img1, img2 = (mesh.shard(t) for t in mesh_frames(MESH_BATCH, device))
    gt = torch.zeros(img1.shape[:3] + (1,), device=device)
    return ev.infer(img1, img2, gt)["gen_masks"].cpu()


def mesh_main_calls(mesh, weights: dict) -> dict:
    """The calls of the phase's main path on the card: the learner's two
    sub-steps, `evaluate_dataset` on the eval phase's batches, one ensemble
    batch and one recover pretraining step."""
    from unsupervised_detection_tpu_torch.eval import EnsembleEvaluator, evaluate_dataset
    from unsupervised_detection_tpu_torch.train.pretrain import RecoverPretrainer

    cfg = Config(batch_size=BATCH, **TRAIN_SIZES)
    out = {"steps": mesh_steps(mesh, weights, "cuda")}
    ev = mesh_nets(cfg, Evaluator, "cuda", weights, mesh)
    out["eval"] = evaluate_dataset(cfg, ev, verbose=False, batches=eval_batches())
    ens = mesh_nets(cfg, EnsembleEvaluator, "cuda", weights, mesh)
    out["ensemble"] = ens.run(next(iter(eval_batches())))
    trainer = RecoverPretrainer(cfg.replace(batch_size=MESH_PRETRAIN_BATCH), "cuda", mesh)
    loss = trainer.step(*(mesh.shard(t) for t in mesh_frames(MESH_PRETRAIN_BATCH, "cuda")))
    out["pretrain"] = {"loss": float(loss), "params": {
        k: v.detach().cpu().clone() for k, v in trainer.recover.named_parameters()}}
    return out


def bit_equal(got, want) -> bool:
    """Nested dicts / lists of tensors, arrays and numbers, equal bit for bit
    (NaN equal to NaN)."""
    import numpy as np

    if isinstance(want, dict):
        return set(got) == set(want) and all(bit_equal(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(bit_equal(g, w) for g, w in zip(got, want))
    if isinstance(want, torch.Tensor):
        return got.dtype == want.dtype and torch.equal(got, want)
    if isinstance(want, np.ndarray):
        return np.array_equal(got, want, equal_nan=True)
    return got == want or (got != got and want != want)


def mesh_rank(rank: int, world: int, backend: str, port: int, out_dir: str) -> None:
    """One spawned rank: the learner's sub-steps on each of MESH_SHAPES and,
    on a model axis, the Evaluator's masks, with their launch counts, and
    then the same calls in this process with no mesh; written to
    out_dir/rank<rank>.pt. The rank takes torchrun's variables and joins
    the group through `mesh_from_env` with `backend` named: under gloo
    every rank shares card 0 (LOCAL_RANK 0); under NCCL rank r takes card
    r."""
    import torch.distributed as dist

    from unsupervised_detection_tpu_torch.parallel.mesh import Mesh, mesh_from_env

    torch.backends.cudnn.deterministic = True
    if backend == "gloo":
        torch.cuda.set_per_process_memory_fraction(MESH_SHARED_CARD_SHARE, 0)
    weights = train_weights()
    out = {}
    try:
        for shape in MESH_SHAPES:
            with torchrun_env(rank, world, rank if backend == "nccl" else 0, port):
                mesh = mesh_from_env(*shape, batch_size=MESH_BATCH, backend=backend)
            device = mesh.device
            # on a model axis, the same steps with no mesh before and after
            before = mesh_steps(Mesh(), weights, device) if mesh.n_model > 1 else None
            torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            run = {"steps": mesh_steps(mesh, weights, device, timed=True),
                   "launches_steps": launch_counts(),
                   "memory": card_memory(device)}
            if mesh.n_model > 1:
                reset_counts()
                run["mask"] = mesh_mask(mesh, weights, device)
                run["launches_mask"] = launch_counts()
                run["one_process"] = {"before": before,
                                      "steps": mesh_steps(Mesh(), weights, device),
                                      "mask": mesh_mask(Mesh(), weights, device)}
            out[shape] = run
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def card_memory(device) -> dict:
    """This process's peak reserved memory since the last reset and the
    card's free memory now, GiB."""
    return {"peak_reserved_gib": torch.cuda.max_memory_reserved(device) / 2**30,
            "card_free_gib": torch.cuda.mem_get_info(device)[0] / 2**30}


def max_excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """The largest |got - want| - (atol + rtol |want|): <= 0 within the limits."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def steps_excess(steps: dict, want: dict) -> dict:
    """`mesh_steps` records against `want`'s: the largest excess over
    MESH_RTOL / MESH_ATOL (<= 0 within) of the 8 losses and of the
    parameters where the gradient fixes them (|g| >= MESH_ADAM_FLOOR), under
    that floor the elements beyond the limits counted with the largest
    difference among them (`hold_steps` limits both); the applied
    gradients' largest difference over the stepped net's largest
    |gradient|."""
    row = {"losses": -1.0, "grads": -1.0, "params": -1.0, "under_floor_beyond": 0,
           "under_floor_max_diff": 0.0, "under_floor": 0, "elements": 0}
    for name in ("generator_step", "recover_step"):
        for k, v in want[name]["losses"].items():
            row["losses"] = max(row["losses"], abs(steps[name]["losses"][k] - v)
                                - (MESH_ATOL + MESH_RTOL * abs(v)))
        scale = max(float(w.abs().max()) for w in want[name]["grads"])
        for g, w in zip(steps[name]["grads"], want[name]["grads"]):
            row["grads"] = max(row["grads"], float((g - w).abs().max()) / scale)
    for net, name in (("gen", "generator_step"), ("rec", "recover_step")):
        for (k, v), g in zip(want["params"][net].items(), want[name]["grads"]):
            got = steps["params"][net][k]
            fixed = g.abs() >= MESH_ADAM_FLOOR
            excess = (got - v).abs() - (MESH_ATOL + MESH_RTOL * v.abs())
            if bool(fixed.any()):
                row["params"] = max(row["params"], float(excess[fixed].max()))
            beyond = ~fixed & (excess > 0)
            row["under_floor_beyond"] += int(beyond.sum())
            row["under_floor"] += int((~fixed).sum())
            row["elements"] += v.numel()
            if bool(beyond.any()):
                row["under_floor_max_diff"] = max(row["under_floor_max_diff"],
                                                  float((got - v).abs()[beyond].max()))
    return row


def hold_steps(what: str, steps: dict, want: dict) -> dict:
    row = steps_excess(steps, want)
    lr = Config().learning_rate
    most = int(MESH_UNDER_FLOOR_SHARE * row["elements"])
    log(f"mesh: {what}: largest excess over rtol {MESH_RTOL} / atol {MESH_ATOL} (<= 0 "
        f"within): losses {row['losses']:.3e}, parameters where |g| >= "
        f"{MESH_ADAM_FLOOR:.3e} {row['params']:.3e}; under that floor "
        f"{row['under_floor_beyond']} of {row['under_floor']} elements beyond the limits (of "
        f"{row['elements']}; limit {most}), by at most {row['under_floor_max_diff']:.3e} "
        f"(limit lr {lr}); gradients {row['grads']:.3e} of the net's largest (limit "
        f"{TRAIN_GRAD_REL})")
    if (row["losses"] > 0 or row["grads"] > TRAIN_GRAD_REL or row["params"] > 0
            or row["under_floor_beyond"] > most or row["under_floor_max_diff"] > lr):
        raise AssertionError(f"mesh: {what}: beyond the limits: {row}")
    return row


def hold_mesh_ranks(label: str, ranks: list, ref: dict, ref_mask: torch.Tensor) -> dict:
    """The spawned ranks' results: on each shape rank 0's steps against one
    process (this one) within the limits of `steps_excess`; parameters
    bit-equal across ranks; 5 cost-volume and 4 warp launches per forward
    on each rank. On a model axis: rank 0's steps bit-equal to the same
    calls with no mesh in its process, before and after them (the other
    ranks apply rank 0's sums: their own no-mesh steps, from another
    process, are compared and logged), and every rank's masks bit-equal to
    its own no-mesh forward (within MASK_TOL of this process's). Logs each
    rank's times."""
    want_steps = {"cost_volume": 20, "warp": 16, "dynamic_copy": 0,
                  "cost_volume_backward": 0, "warp_backward": 0}
    summary = {}
    for shape in MESH_SHAPES:
        runs = [r[shape] for r in ranks]
        row = summary[f"{shape[0]}x{shape[1]}"] = {
            "ms": [r["steps"]["ms"] for r in runs],
            "against_one_process": hold_steps(f"{label} {shape} against one process",
                                              runs[0]["steps"], ref["steps"])}
        for rank, run in enumerate(runs):
            steps = run["steps"]
            if rank > 0 and not bit_equal(steps["params"], runs[0]["steps"]["params"]):
                raise AssertionError(f"mesh: {label} {shape}: parameters differ on rank {rank}")
            if run["launches_steps"] != want_steps:
                raise AssertionError(f"mesh: {label} {shape} rank {rank}: launches in 4 "
                                     f"sub-steps {run['launches_steps']}, expected {want_steps}")
            broadcast = ("" if shape[1] == 1 else
                         f", its model-group broadcast alone "
                         f"{steps['ms']['generator_broadcast']:.3f} / "
                         f"{steps['ms']['recover_broadcast']:.3f} ms")
            log(f"mesh: {label} {shape} rank {rank}: ms per generator / recover step "
                f"{steps['ms']['generator_step']:.3f} / {steps['ms']['recover_step']:.3f} (CUDA "
                f"events), one flat reduction {steps['ms']['generator_reduction']:.3f} / "
                f"{steps['ms']['recover_reduction']:.3f} ms{broadcast} (host clock, median of "
                f"5), fp32 r=2 global batch {MESH_BATCH}; launches "
                f"{json.dumps(run['launches_steps'])} in 4 sub-steps; memory "
                f"{json.dumps(run['memory'])} [{card_line()}]")
            if shape[1] == 1:
                continue
            one = run["one_process"]
            same_mask = bit_equal(run["mask"], one["mask"])
            mask_err = float((run["mask"] - ref_mask).abs().max())
            def same(x, y):
                return all(bit_equal(x[k], y[k])
                           for k in ("generator_step", "recover_step", "params"))

            bits = {"no mesh before = after": same(one["before"], one["steps"]),
                    "mesh = no mesh before": same(steps, one["before"]),
                    "mesh = no mesh after": same(steps, one["steps"])}
            log(f"mesh: {label} {shape} rank {rank}: mask bit-equal to no mesh in its process "
                f"{same_mask}, to rank 0's {bit_equal(run['mask'], runs[0]['mask'])}, against "
                f"this process's {mask_err:.3e} (limit {MASK_TOL}); "
                f"launches {json.dumps(run['launches_mask'])} in one forward; the two "
                f"sub-steps, in that process, bit-equal: {json.dumps(bits)}")
            row.setdefault("steps_bit_equal", []).append(bits)
            if rank > 0:
                # the rank applies rank 0's sums; its own steps come from another process
                row.setdefault("other_process", []).append(steps_excess(one["steps"], steps))
                log(f"mesh: {label} {shape} rank {rank}: its own no-mesh steps against rank "
                    f"0's: {json.dumps(row['other_process'][-1])}")
            elif not all(bits.values()):
                raise AssertionError(f"mesh: {label} {shape} rank 0: {bits}")
            if (not same_mask or mask_err > MASK_TOL
                    or (run["launches_mask"]["cost_volume"], run["launches_mask"]["warp"]) != (5, 4)):
                raise AssertionError(f"mesh: {label} {shape} rank {rank}: mask bit-equal "
                                     f"{same_mask}, {mask_err}, {run['launches_mask']}")
        log(f"mesh: {label} {shape}: parameters bit-equal across ranks")
    return summary


def mesh_spawn(label: str, backend: str, ref: dict, ref_mask: torch.Tensor) -> dict:
    import gc
    import tempfile

    import torch.multiprocessing as mp

    # the ranks share the card with this process: hand back its cached blocks
    # (cuBLAS's workspaces, held in the caching allocator, pin whole segments)
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    need = 2 * MESH_SHARED_CARD_SHARE * total if backend == "gloo" else 0.0
    log(f"mesh: {label}: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB, "
        f"the card has {free / 2**30:.2f} GiB free (the ranks' shares {need / 2**30:.2f})")
    if free < need:
        raise RuntimeError(f"mesh: {label}: the ranks' shares of the card need "
                           f"{need / 2**30:.2f} GiB, {free / 2**30:.2f} GiB are free")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        context = mp.spawn(mesh_rank, args=(2, backend, free_port(), tmp), nprocs=2,
                           join=False)
        while not context.join(timeout=max(0.0, MESH_RANK_TIMEOUT - (time.perf_counter() - t0))):
            if time.perf_counter() - t0 >= MESH_RANK_TIMEOUT:
                for proc in context.processes:
                    proc.terminate()
                raise TimeoutError(f"mesh: {label}: ranks still running after "
                                   f"{MESH_RANK_TIMEOUT} s")
        log(f"mesh: {label}: 2 ranks spawned and run in {time.perf_counter() - t0:.1f} s")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    return hold_mesh_ranks(label, ranks, ref, ref_mask)


def phase_mesh(report: dict) -> None:
    """The mesh at world 1 under NCCL (the phase's main path, bit-equal to
    no process group), 2 ranks on the card under gloo, and 2 cards under
    NCCL where there are two."""
    import torch.distributed as dist

    from unsupervised_detection_tpu_torch.parallel.mesh import Mesh, mesh_from_env

    weights = train_weights()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        ref = mesh_main_calls(Mesh(), weights)
        torch.cuda.empty_cache()
        ref_mask = mesh_mask(Mesh(), weights, "cuda")
        try:
            with torchrun_env(0, 1, 0, free_port()):
                mesh = mesh_from_env(batch_size=MESH_BATCH)
            reset_counts()
            t0 = time.perf_counter()
            got = mesh_main_calls(mesh, weights)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            report["launches_mesh"] = launch_counts()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        same = {k: bit_equal(got[k], ref[k]) for k in ref}
        want = {"cost_volume": 35, "warp": 28, "dynamic_copy": 0, "cost_volume_backward": 0,
                "warp_backward": 0}
        log(f"mesh: world 1 under NCCL ({seconds:.2f} s): bit-equal to no process group "
            f"{json.dumps(same)}; launches {json.dumps(report['launches_mesh'])} in 2 sub-steps, "
            f"3 evaluation batches, 1 ensemble batch and 1 pretraining step; evaluation IoU "
            f"{got['eval']['dataset_iou']}, MAE {got['eval']['dataset_mae']}")
        if not all(same.values()) or report["launches_mesh"] != want:
            raise AssertionError(f"mesh: world 1: {same}, launches {report['launches_mesh']} "
                                 f"(expected {want})")
        out["gloo_one_card"] = mesh_spawn("gloo, 2 ranks on one card", "gloo", ref, ref_mask)
        if torch.cuda.device_count() >= 2:
            out["nccl_two_cards"] = mesh_spawn("NCCL, 2 cards", "nccl", ref, ref_mask)
        else:
            log(f"mesh: NCCL across cards not run: torch.cuda.device_count() is "
                f"{torch.cuda.device_count()}")
    finally:
        torch.backends.cudnn.deterministic = saved
    report["mesh"] = out


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
        return {k: {key: v[key] for key in ("device_ms", "ms", "digest") if key in v}
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
        elif phase == "postproc":
            phase_postproc(report)
        elif phase == "tf1":
            phase_tf1(report)
        elif phase == "jmean":
            phase_jmean(report)
        elif phase == "recipe":
            phase_recipe(report)
        elif phase == "gametools":
            phase_gametools(report)
        elif phase == "train":
            phase_train(report)
        elif phase == "pretrain":
            phase_pretrain(report)
        elif phase == "mesh":
            phase_mesh(report)
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
            "launches_postproc": report["launches_postproc"][name],
            "launches_tf1": report["launches_tf1"].get(name, 0),
            "launches_jmean": report["launches_jmean"][name],
            "launches_recipe": report["launches_recipe"][name],
            "launches_gametools": report["launches_gametools"][name],
            "launches_scan": report["launches_scan"][name],
            "launches_train": 0 if backward else report["launches_train"][name],
            "launches_pretrain": report["launches_pretrain"][name],
            "launches_mesh": report["launches_mesh"][name],
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
