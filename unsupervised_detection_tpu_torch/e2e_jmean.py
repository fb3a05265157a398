"""End-to-end J-mean of the port on rendered videos: the whole evaluation
chain through the port's CLIs, counterpart of the JAX repo's
tools/exp_e2e_jmean.py with its dataset, flags and report:

    python -m unsupervised_detection_tpu_torch.e2e_jmean OUT_ROOT \\
        [--ckpt_file=weights_torch/flagship_v2lr_r2.npz] \\
        [--stages=render,raw,buffer,post,report] [--device=cpu]

Stages, each reading what the earlier ones wrote under OUT_ROOT:

  render  OUT_ROOT/DAVIS    5 sequences x 24 frames at 192x384, seed 17
  raw     raw_*.log         test_generator, float32 and bfloat16
  buffer  OUT_ROOT/buffer   test_generator_ensemble for the shifts -2, -1,
                            1, 2 at batch 1, its .mat buffers
  post    soft, crf, crf_original
                            post_processing --discover_sequences
                            --benchmark, the PWC net as the propagation
                            flow and the native CRF
  report  REPORT.md         every stage's IoU and the per-sequence table

The CLIs run in this process, through their `main(argv, device)`.
`--ckpt_file` is an evaluation checkpoint of search range 2; the default
is the committed export of the flagship (weights_torch/README.md). Runs on
the card unless `--device=cpu` is given, and raises without a card
otherwise. Every stage's numbers and seconds are merged into
OUT_ROOT/results.json, which the report reads.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np

from . import post_processing, test_generator, test_generator_ensemble
from .device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_FILE = os.path.join(REPO, "weights_torch", "flagship_v2lr_r2.npz")
STAGES = ("render", "raw", "buffer", "post", "report")

H, W = 192, 384
SQUARE = 48
FRAMES = 24
# wobble_e is deformable: an elliptical blob whose radius varies with angle
# and time, so neither its silhouette nor its interior flow is affine.
SEQS = ("pan_a", "zoom_b", "drift_c", "shear_d", "wobble_e")
SEARCH_RANGE = 2  # the flagship PWC checkpoint's cost-volume range
SEED = 17
SHIFTS = (-2, -1, 1, 2)
RAW_BATCH = 8
# the ensemble buffer runs one frame per batch: the soft score reads the
# same frame numbers under every shift, which a wrapped last batch breaks
BUFFER_BATCH = 1


# --- render ---------------------------------------------------------------

def _texture(rng, h, w, scale, amp):
    import cv2

    base = rng.rand(max(h // scale, 1), max(w // scale, 1), 3).astype(np.float32)
    return amp * (cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR) - 0.5)


def _affine_flow_matrix(a, b, c, h, w):
    """3x3 homogeneous map p -> p + F(p) for the affine flow
    F_x(p) = a_x + b_x*(x - W/2)/W + c_x*(y - H/2)/H."""
    m = np.eye(3)
    m[0, 0] += b[0] / w
    m[0, 1] += c[0] / h
    m[0, 2] += a[0] - b[0] / 2 - c[0] / 2
    m[1, 0] += b[1] / w
    m[1, 1] += c[1] / h
    m[1, 2] += a[1] - b[1] / 2 - c[1] / 2
    return m


def _sample_grid(m, h, w):
    """Map every pixel (x, y) through homogeneous matrix m -> (map_x, map_y)."""
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    den = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    map_x = (m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / den
    map_y = (m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / den
    return map_x.astype(np.float32), map_y.astype(np.float32)


def render_dataset(root, seed=SEED):
    """DAVIS2016-layout tree of affine-motion videos: JPEG frames (quality
    95) and PNG masks, every frame listed in the val, trainval and train
    partitions. Background and object carry independent motions, and
    frames are rendered analytically from persistent textures, so
    consecutive pairs have photometrically consistent motion."""
    import cv2

    os.makedirs(os.path.join(root, "ImageSets/480p"), exist_ok=True)
    val_lines = []
    margin = 260  # bounds total bg drift over FRAMES
    rng = np.random.RandomState(seed)
    for seq in SEQS:
        img_dir = os.path.join(root, "JPEGImages/480p", seq)
        ann_dir = os.path.join(root, "Annotations/480p", seq)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(ann_dir, exist_ok=True)

        th, tw = H + 2 * margin, W + 2 * margin
        bg_tex = _texture(rng, th, tw, 8, 0.6) + _texture(rng, th, tw, 2, 0.25)
        wobble = seq == "wobble_e"
        R0, TEX = SQUARE // 2 + 8, 2 * (SQUARE // 2 + 8) + 8
        obj_side = TEX if wobble else SQUARE
        sq_tex = (_texture(rng, obj_side, obj_side, 4, 0.7)
                  + rng.uniform(-0.2, 0.2))

        # background motion per frame, constant per sequence: up to ~6 px
        # of translation, a few px of gradient across the frame
        styles = {
            "pan_a": dict(a=(5.0, 2.0), b=(0.0, 0.0), c=(0.0, 0.0)),
            "zoom_b": dict(a=(1.0, -1.5), b=(3.0, 0.5), c=(0.5, 3.0)),
            "drift_c": dict(a=(-4.0, 3.0), b=(-2.0, 0.0), c=(0.0, -2.0)),
            "shear_d": dict(a=(2.5, -2.0), b=(0.0, 4.0), c=(-4.0, 0.0)),
            "wobble_e": dict(a=(3.0, -2.5), b=(1.0, -1.0), c=(1.0, 1.0)),
        }[seq]
        w_bg = _affine_flow_matrix(styles["a"], styles["b"], styles["c"], H, W)

        # object: constant velocity between two centers inside the frame;
        # squares also scale slowly, the blob deforms
        half = R0 * 1.3 if wobble else SQUARE / 2.0
        y0 = rng.randint(40, int(H - 2 * half - 40)) + half
        x0 = rng.randint(30, 150) + half
        y1 = rng.randint(40, int(H - 2 * half - 40)) + half
        x1 = rng.randint(W - 190, int(W - 2 * half - 30)) + half
        vy, vx = (y1 - y0) / FRAMES, (x1 - x0) / FRAMES
        scale = rng.uniform(0.99, 1.012)

        m_bg = np.eye(3)
        for f in range(FRAMES):
            mx, my = _sample_grid(m_bg, H, W)
            frame = cv2.remap(bg_tex, mx + margin, my + margin,
                              cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
            cy, cx = y0 + vy * f, x0 + vx * f
            xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                                 np.arange(H, dtype=np.float32))
            if wobble:
                # boundary r(theta, t) breathes around R0; texture coords
                # normalize the radius, so the interior stretches with it
                dy, dx = ys - cy, xs - cx
                rho = np.sqrt(dx * dx + dy * dy) + 1e-6
                theta = np.arctan2(dy, dx)
                r_t = R0 * (1.0 + 0.18 * np.sin(3 * theta + 0.35 * f)
                            + 0.10 * np.cos(2 * theta - 0.5 * f))
                inside = rho < r_t
                qx = (dx * (R0 / r_t) + TEX / 2.0).astype(np.float32)
                qy = (dy * (R0 / r_t) + TEX / 2.0).astype(np.float32)
            else:
                s_t = scale ** f
                qx = (xs - cx) / s_t + SQUARE / 2.0
                qy = (ys - cy) / s_t + SQUARE / 2.0
                inside = ((qx >= 0) & (qx < SQUARE)
                          & (qy >= 0) & (qy < SQUARE))
            sq = cv2.remap(sq_tex, qx.astype(np.float32), qy.astype(np.float32),
                           cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
            frame = np.where(inside[..., None], sq, frame)
            frame_u8 = np.clip((frame + 0.5) * 255.0, 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(img_dir, "%05d.jpg" % f),
                        cv2.cvtColor(frame_u8, cv2.COLOR_RGB2BGR),
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
            cv2.imwrite(os.path.join(ann_dir, "%05d.png" % f),
                        (inside * 255).astype(np.uint8))
            val_lines.append(
                "/JPEGImages/480p/%s/%05d.jpg /Annotations/480p/%s/%05d.png"
                % (seq, f, seq, f))

            m_bg = w_bg @ m_bg

    for part in ("val", "trainval", "train"):
        with open(os.path.join(root, "ImageSets/480p", part + ".txt"), "w") as fh:
            fh.write("\n".join(val_lines) + "\n")
    print("rendered %d sequences x %d frames at %dx%d -> %s"
          % (len(SEQS), FRAMES, H, W, root), flush=True)


# --- the CLIs --------------------------------------------------------------

def common_flags(root, ckpt_path, dtype="float32"):
    """The evaluation CLIs' flags for the tree under `root`/DAVIS."""
    return [
        "--dataset=DAVIS2016", "--root_dir=" + os.path.join(root, "DAVIS"),
        "--test_partition=val", "--test_temporal_shift=1",
        "--img_height=%d" % H, "--img_width=%d" % W,
        "--reader_height=%d" % H, "--reader_width=%d" % W,
        "--pwc_search_range=%d" % SEARCH_RANGE,
        "--batch_size=%d" % RAW_BATCH, "--num_threads=2",
        "--compute_dtype=" + dtype,
        "--ckpt_file=" + ckpt_path,
    ]


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def run_logged(cli_main, argv, device, log_path):
    """(cli_main(argv, device=device), its printed lines), the lines also
    written to `log_path` and passed on to stdout."""
    with open(log_path, "w") as fh, contextlib.redirect_stdout(_Tee(sys.stdout, fh)):
        result = cli_main(argv, device=device)
    with open(log_path) as fh:
        return result, fh.read()


def parse_avg_iou(out):
    m = re.search(r"The Average over the dataset: IoU is ([0-9.]+)", out)
    return float(m.group(1)) if m else None


def parse_category_ious(out):
    """Per-sequence IoU from an evaluation CLI's log."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"Category (\S+): IoU is ([0-9.]+)", out)}


def score_soft_tree(soft_dir, key="pred_mask", threshold=0.1, per_seq=None):
    """Mean IoU of a soft-score tree's masks vs their stored GT (binarized
    at the reference's 0.1). With `per_seq` a dict, also records each
    sequence's mean IoU into it."""
    import scipy.io as sio

    ious = []
    for seq in sorted(os.listdir(soft_dir)):
        seq_dir = os.path.join(soft_dir, seq)
        seq_ious = []
        for fname in sorted(os.listdir(seq_dir)):
            if not fname.endswith(".mat"):
                continue
            r = sio.loadmat(os.path.join(seq_dir, fname))
            if key not in r:
                return None
            pred = np.squeeze(r[key]) > threshold
            gt = np.squeeze(r["gt_mask"]) > 0.1
            denom = float(np.sum(pred | gt))
            seq_ious.append(float(np.sum(pred & gt)) / denom if denom else 0.0)
        ious.extend(seq_ious)
        if per_seq is not None and seq_ious:
            per_seq[seq] = float(np.mean(seq_ious))
    return float(np.mean(ious)) if ious else None


# --- stages ----------------------------------------------------------------

def _short(dtype):
    return {"float32": "fp32", "bfloat16": "bf16"}[dtype]


def raw_stage(out_root, ckpt_path, dtype="float32", device=None):
    """test_generator on the tree in `dtype`: {"dataset_iou",
    "category_iou" (read from its printed lines), "dataset_mae", "frames",
    "seconds"}."""
    t0 = time.perf_counter()
    res, out = run_logged(test_generator.main, common_flags(out_root, ckpt_path, dtype),
                          device, os.path.join(out_root, "raw_%s.log" % _short(dtype)))
    return {"dataset_iou": parse_avg_iou(out), "category_iou": parse_category_ious(out),
            "dataset_mae": res["dataset_mae"], "frames": res["frames"],
            "seconds": time.perf_counter() - t0}


def buffer_stage(out_root, ckpt_path, device=None):
    """The ensemble CLI for every shift, writing its buffers: {shift: its
    result dict with "seconds"}."""
    out = {}
    for shift in SHIFTS:
        flags = common_flags(out_root, ckpt_path)
        flags[3] = "--test_temporal_shift=%d" % shift
        flags += ["--batch_size=%d" % BUFFER_BATCH, "--generate_visualization=True",
                  "--test_save_dir=" + os.path.join(out_root, "buffer", "davis_shift_%d" % shift)]
        t0 = time.perf_counter()
        res, _ = run_logged(test_generator_ensemble.main, flags, device,
                            os.path.join(out_root, "ensemble_shift%d.log" % shift))
        out[shift] = dict(res, seconds=time.perf_counter() - t0)
    return out


def post_stage(out_root, ckpt_path, device=None):
    """post_processing on the buffer with the PWC flow of `ckpt_path`, then
    the soft-score trees scored: {"soft_score", "propagated_f", "post_crf",
    "post_crf_original", "post_crf_rescored", "per_seq", "seconds"}."""
    davis = os.path.join(out_root, "DAVIS")
    soft = os.path.join(out_root, "soft")
    crf = os.path.join(out_root, "crf")
    t0 = time.perf_counter()
    res, _ = run_logged(post_processing.main, [
        "--path_buffer=" + os.path.join(out_root, "buffer"),
        "--out_soft_score=" + soft,
        "--resized_out=" + crf,
        "--original_out=" + os.path.join(out_root, "crf_original"),
        "--path_img=" + os.path.join(davis, "JPEGImages/480p"),
        "--path_gt=" + os.path.join(davis, "Annotations/480p"),
        "--flow_backend=pwc", "--flow_ckpt=" + ckpt_path,
        "--pwc_search_range=%d" % SEARCH_RANGE,
        "--discover_sequences", "--benchmark",
    ], device, os.path.join(out_root, "post.log"))
    seconds = time.perf_counter() - t0
    per_seq = {"soft_score": {}, "post_crf": {}}
    return {"post_crf": res["iou_resized"], "post_crf_original": res["iou_original"],
            "soft_score": score_soft_tree(soft, "pred_mask", per_seq=per_seq["soft_score"]),
            "propagated_f": score_soft_tree(soft, "running_avg_f"),
            "post_crf_rescored": score_soft_tree(crf, "mask", per_seq=per_seq["post_crf"]),
            "per_seq": per_seq, "seconds": seconds}


def report(results, ckpt_path):
    """REPORT.md's text: the stages' mean IoU, and per sequence the raw,
    soft-score and CRF IoU."""
    lines = [
        "# Synthetic end-to-end J-mean of the PyTorch port", "",
        "Checkpoint: %s (search_range=%d)." % (os.path.basename(ckpt_path), SEARCH_RANGE),
        "Dataset: %d rendered sequences x %d frames at %dx%d (affine bg"
        % (len(SEQS), FRAMES, H, W),
        "+ independently-moving, slowly-scaling textured square;",
        "wobble_e is a non-rigidly DEFORMING blob).",
        "", "| stage | mean IoU |", "|---|---|",
    ]
    for k in ("raw_fp32", "raw_bf16", "soft_score", "propagated_f", "post_crf",
              "post_crf_original"):
        if results.get(k) is not None:
            lines.append("| %s | %.4f |" % (k, results[k]))
    lines.append("")
    per_seq = results.get("per_seq", {})
    stage_keys = [k for k in ("raw_fp32", "soft_score", "post_crf") if per_seq.get(k)]
    if stage_keys:
        lines += ["Per-sequence IoU (raw -> soft-score ensemble -> CRF; all at the 0.1 "
                  "threshold):", "",
                  "| sequence | " + " | ".join(stage_keys) + " |",
                  "|---|" + "---|" * len(stage_keys)]
        for seq in SEQS:
            row = [("%.4f" % per_seq[k][seq]) if seq in per_seq[k] else "-"
                   for k in stage_keys]
            lines.append("| %s | %s |" % (seq, " | ".join(row)))
        lines.append("")
    if results.get("raw_fp32") and results.get("post_crf"):
        lines.append("Post-processing lift (CRF vs raw fp32): %+.4f."
                     % (results["post_crf"] - results["raw_fp32"]))
    if results.get("raw_fp32") and results.get("raw_bf16"):
        lines.append("bf16-vs-fp32 raw IoU delta: %+.4f."
                     % (results["raw_bf16"] - results["raw_fp32"]))
    return "\n".join(lines) + "\n"


def _parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_root")
    parser.add_argument("--ckpt_file", default=CKPT_FILE)
    parser.add_argument("--stages", default=",".join(STAGES))
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU; the card by default")
    return parser


def main(argv) -> dict:
    """Run the chain's `--stages` on `argv`'s OUT_ROOT. Returns every
    stage's numbers and seconds (with those of earlier runs under the same
    OUT_ROOT): "raw_fp32", "raw_bf16" (dataset IoU), "raw" (each dtype's
    raw_stage dict), "buffer", "soft_score", "propagated_f", "post_crf",
    "post_crf_original", "post_crf_rescored", "per_seq", "seconds"."""
    args = _parser().parse_args(argv)
    resolve_device(args.device)     # no card and no --device=cpu: raise now
    device = args.device
    stages = args.stages.split(",")
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise SystemExit("unknown stages %s; the stages are %s" % (sorted(unknown), STAGES))
    os.makedirs(args.out_root, exist_ok=True)
    ckpt = os.path.abspath(args.ckpt_file)
    results_path = os.path.join(args.out_root, "results.json")
    results = {"per_seq": {}, "seconds": {}}
    if os.path.exists(results_path):
        with open(results_path) as fh:
            results = json.load(fh)

    if "render" in stages:
        t0 = time.perf_counter()
        render_dataset(os.path.join(args.out_root, "DAVIS"))
        results["seconds"]["render"] = time.perf_counter() - t0
    if "raw" in stages:
        results["raw"] = {}
        for dtype in ("float32", "bfloat16"):
            raw = raw_stage(args.out_root, ckpt, dtype, device)
            results["raw"][dtype] = raw
            results["raw_" + _short(dtype)] = raw["dataset_iou"]
            results["seconds"]["raw_" + _short(dtype)] = raw["seconds"]
            print("RAW %s IoU: %s" % (_short(dtype), raw["dataset_iou"]), flush=True)
        results["per_seq"]["raw_fp32"] = results["raw"]["float32"]["category_iou"]
    if "buffer" in stages:
        results["buffer"] = {str(s): r for s, r in
                             buffer_stage(args.out_root, ckpt, device).items()}
        results["seconds"]["buffer"] = sum(r["seconds"] for r in results["buffer"].values())
    if "post" in stages:
        post = post_stage(args.out_root, ckpt, device)
        results["per_seq"].update(post.pop("per_seq"))
        results["seconds"]["post"] = post.pop("seconds")
        results.update(post)
    if "report" in stages:
        text = report(results, ckpt)
        with open(os.path.join(args.out_root, "REPORT.md"), "w") as fh:
            fh.write(text)
        print(text, flush=True)
    with open(results_path, "w") as fh:
        json.dump(results, fh, indent=1)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
