"""Batched evaluation, counterpart of
unsupervised_detection_tpu/eval/evaluator.py: `Evaluator.infer` (masks
and the working-resolution inputs),
`Evaluator.infer_metrics` (IoU/MAE reduced on the device),
`Evaluator.device_batch`, the reference's host metrics, and
`evaluate_dataset` with its metrics-only path and its dense path (overlay
PNGs and `result_<n>.mat` files).

On a mesh (parallel/mesh.py) each rank infers its rows of every batch and
`evaluate_dataset` gathers the per-frame results over the data group in
global order, so its bookkeeping, wrapped duplicates included, is one
process's on every rank; global rank 0 alone prints and writes the
files."""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import cv2
import numpy as np
import scipy.io as sio
import torch

from ..config import Config
from ..data import TestPipeline, get_reader
from ..data.device_input import DeviceFeeder
from ..device import precision_scope
from ..ops.metrics import eval_iou_mae
from ..ops.resize import central_crop_resize, resize_nearest
from ..parallel.mesh import Mesh
from ..train.objective import AdversarialObjective
from ..utils.profiling import span
from ..utils.visualization import postprocess_image, postprocess_mask

DES_WIDTH = 640
DES_HEIGHT = 384
BOUNDARY_THRESHOLD = 0.6  # test_generator.py:16
MASK_THRESHOLD = 0.1      # test_generator.py:19


def compute_boundary_score_np(mask: np.ndarray) -> float:
    """Reference numpy boundary score (general_utils.py:117-132)."""
    h, w = mask.shape[0], mask.shape[1]
    strips = [mask[0:2], mask[h - 2:h], mask[:, 0:2], mask[:, w - 2:w]]
    occ = sum(float(np.sum(s)) for s in strips)
    total = sum(s.size for s in strips)
    return occ / total


def compute_iou_np(gt_mask: np.ndarray, pred_mask_f: np.ndarray,
                   threshold: float = MASK_THRESHOLD):
    """Reference compute_IoU (test_generator.py:19-35): binarize, pick the
    side of the mask occupying < 60% of the border as foreground, IoU.
    Returns (IoU, the binary foreground annotation)."""
    gt = gt_mask.astype(bool)
    pred = pred_mask_f > threshold
    if compute_boundary_score_np(pred) < BOUNDARY_THRESHOLD:
        annotation = pred
    else:
        annotation = np.logical_not(pred)
    if np.isclose(np.sum(annotation), 0) and np.isclose(np.sum(gt), 0):
        return 1.0, annotation
    return (
        np.sum(annotation & gt) / np.sum(annotation | gt, dtype=np.float32),
        annotation,
    )


def compute_mae_np(gt_mask: np.ndarray, pred_mask: np.ndarray) -> float:
    return float(np.mean(np.abs(gt_mask.astype(np.float32) - pred_mask)))


class Evaluator:
    """Mask inference + IoU/MAE for one config on one device, on this
    rank's `mesh` (None: the trivial one).

    `device=None` means the first CUDA device and raises without one. In
    float32 every call runs with TF32 off for cuDNN and matmul
    (`device.precision_scope`, entered per call and restored after).
    `infer` and `infer_metrics` compute the rows they are given.
    """

    def __init__(self, config: Config, device=None, mesh: Mesh | None = None):
        self.config = config
        self.mesh = mesh if mesh is not None else Mesh()
        self.objective = AdversarialObjective(config, device, self.mesh)
        self.device = self.objective.device
        self.feeder = DeviceFeeder((config.reader_height, config.reader_width), self.device,
                                   self.mesh)

    def load_state_dicts(self, gen_state: dict, pwc_state: dict) -> None:
        self.objective.load_state_dicts(gen_state, pwc_state)

    def device_batch(self, batch):
        """Raw/host batch (a `TestPipeline` dict) -> reader-resolution
        (img1, img2, gt) on the device: this rank's rows."""
        with span("ud.data.device_batch"):
            img1, img2 = self.feeder.images(batch)
            return img1, img2, self.feeder.mask(batch)

    def _masks(self, img1, img2, gt):
        """The reference order (build_test_graph, adversarial_learner.py:
        450-523): central crop, PWC flow, working resize, mask; the ground
        truth's resize to the working resolution, which nothing else reads,
        is taken with the crop. Returns the working-resolution (image, flow,
        gt, mask)."""
        cfg, obj = self.config, self.objective
        with span("ud.model.crop"):
            img1, img2, gt = (t.to(self.device) for t in (img1, img2, gt))
            if cfg.test_crop != 1.0:
                img1 = central_crop_resize(img1, cfg.test_crop)
                img2 = central_crop_resize(img2, cfg.test_crop)
                gt = central_crop_resize(gt, cfg.test_crop)
            gt = resize_nearest(gt, (cfg.img_height, cfg.img_width))
        flow = obj.compute_flow(img1, img2)
        image, flow = obj.resize_to_working(img1, flow)
        return image, flow, gt, obj.generate_mask(image, flow)

    @torch.inference_mode()
    def infer(self, img1: torch.Tensor, img2: torch.Tensor,
              gt: torch.Tensor) -> dict[str, torch.Tensor]:
        """The dense outputs of one batch, float32 on the device:
        `gen_masks` (B, h, w, 1), `input_image`, `gt_flow` (the
        working-resolution flow the generator saw) and `gt_masks`, at the
        working resolution (h, w). Inputs as `infer_metrics`. The JAX
        package's `infer` also runs the recover net for a `pred_flow` that
        nothing reads; this one skips it, as `infer_metrics` does."""
        with precision_scope(self.objective.dtype):
            image, flow, gt, mask = self._masks(img1, img2, gt)
        return {"gen_masks": mask.float(), "input_image": image.float(),
                "gt_flow": flow.float(), "gt_masks": gt.float()}

    @torch.inference_mode()
    def infer_metrics(self, img1: torch.Tensor, img2: torch.Tensor,
                      gt: torch.Tensor) -> dict[str, torch.Tensor]:
        """Per-frame IoU and MAE of the predicted masks.

        img1, img2: (B, reader_h, reader_w, 3) in [-0.5, 0.5]; gt: (B,
        reader_h, reader_w, 1). The masks of `_masks`, then the exact
        test_generator.py:19-40 metrics (the recover forward is skipped; it
        never enters the metrics).
        """
        with precision_scope(self.objective.dtype):
            _, _, gt, mask = self._masks(img1, img2, gt)
            with span("ud.eval.metrics"):
                iou_b, mae_b = eval_iou_mae(mask.float(), gt.float())
        return {"iou": iou_b, "mae": mae_b}


def build_test_pipeline(config: Config, mesh: Mesh | None = None) -> TestPipeline:
    """The dataset's evaluation stream, as the JAX evaluate_dataset builds
    it: FBMS from its annotated test tuples (host mode), DAVIS2016 from the
    test partition (raw mode), SegTrack from all sequences (host mode). On a
    data axis wider than one it decodes only `mesh`'s rows of each batch."""
    rows = (mesh or Mesh()).batch_rows(config.batch_size)
    reader = get_reader(config.dataset, config.root_dir,
                        max_temporal_len=config.max_temporal_len,
                        min_temporal_len=config.min_temporal_len,
                        num_threads=1)
    reader_hw = (config.reader_height, config.reader_width)
    if config.dataset == "FBMS":
        tuples = reader.test_tuples(config.test_partition, config.test_temporal_shift)
        return TestPipeline(None, config.batch_size, config.test_temporal_shift,
                            reader_hw=reader_hw, raw_hw=None,
                            num_threads=config.num_threads, explicit_tuples=tuples, rows=rows)
    partition = config.test_partition if config.dataset == "DAVIS2016" else "all"
    ds = reader.dataset(partition)
    raw_hw = (reader.raw_height, reader.raw_width) if reader.raw_height is not None else None
    return TestPipeline(ds, config.batch_size, config.test_temporal_shift,
                        reader_hw=reader_hw, raw_hw=raw_hw, num_threads=config.num_threads,
                        rows=rows)


def evaluate_dataset(config: Config, evaluator: Evaluator, save_dir: Optional[str] = None,
                     generate_visualization: bool = False, verbose: bool = True,
                     batches: Optional[Iterable[dict]] = None):
    """Full dataset evaluation with the weights loaded in `evaluator`;
    prints and returns the metrics (test_generator.py:42-132).

    The stream is built from `config` (`build_test_pipeline`) unless `batches`
    gives one: an iterable of `TestPipeline` batch dicts, for callers that
    feed frames without decoding files (global batches). Wrapped duplicates
    of the last batch count, in the frame count and in their category, as
    in the JAX loop. On a mesh the results are the global batch's on every
    rank, and only global rank 0 prints and writes.

    With `generate_visualization` and `save_dir` the dense path runs
    (`Evaluator.infer`): the metrics are the
    reference's host ones, and each frame leaves `<save_dir>/<category>/
    frame_<n:08d>.png` (the mask over the image, at 640x384) and
    `result_<n>.mat` (flow, img1, pred_mask, gt_mask), n counting the
    category's frames from 1, wrapped duplicates included.
    """
    mesh = evaluator.mesh
    dense = bool(generate_visualization and save_dir)
    verbose = verbose and mesh.is_main
    if batches is None:
        batches = build_test_pipeline(config, mesh)

    category_iou: Dict[str, list] = {}
    category_mae: Dict[str, list] = {}
    i = 0
    batches = iter(batches)
    while True:
        with span("ud.eval.feed"):
            batch = next(batches, None)
        if batch is None:
            break
        if not dense:
            out = evaluator.infer_metrics(*evaluator.device_batch(batch))
            with span("ud.eval.result_copy"):
                ious = mesh.gather_data(out["iou"]).cpu().numpy()
                maes = mesh.gather_data(out["mae"]).cpu().numpy()
            for b in range(ious.shape[0]):
                category = batch["category"][b]
                category_iou.setdefault(category, []).append(float(ious[b]))
                category_mae.setdefault(category, []).append(float(maes[b]))
                i += 1
            continue
        out = evaluator.infer(*evaluator.device_batch(batch))
        with span("ud.eval.result_copy"):
            out = {k: mesh.gather_data(v).cpu().numpy() for k, v in out.items()}
        for b in range(out["input_image"].shape[0]):
            gt_mask = out["gt_masks"][b]
            category = batch["category"][b]
            iou, out_mask = compute_iou_np(gt_mask=gt_mask, pred_mask_f=out["gen_masks"][b])
            category_iou.setdefault(category, []).append(iou)
            category_mae.setdefault(category, []).append(
                compute_mae_np(gt_mask=gt_mask, pred_mask=out_mask))
            if mesh.is_main:
                _save_frame(os.path.join(save_dir, category), len(category_iou[category]),
                            out, b, out_mask)
            i += 1

    tot_ious = tot_maes = 0.0
    per_cat_iou = []
    for cat, list_iou in category_iou.items():
        if verbose:
            print("Category {}: IoU is {} and MAE is {}".format(
                cat, np.mean(list_iou), np.mean(category_mae[cat])))
        tot_ious += np.sum(list_iou)
        tot_maes += np.sum(category_mae[cat])
        per_cat_iou.append(np.mean(list_iou))
    results = {
        "dataset_iou": tot_ious / float(i),
        "dataset_mae": tot_maes / float(i),
        "sequence_iou": float(np.mean(per_cat_iou)),
        "category_iou": {k: float(np.mean(v)) for k, v in category_iou.items()},
        "category_mae": {k: float(np.mean(v)) for k, v in category_mae.items()},
        "frames": i,
    }
    if verbose:
        print("The Average over the dataset: IoU is {} and MAE is {}".format(
            results["dataset_iou"], results["dataset_mae"]))
        print("The Average over sequences IoU is {}".format(results["sequence_iou"]))
        print("Success: Processed {} frames".format(i))
    return results


def _save_frame(cat_dir: str, frame_id: int, out: dict, b: int, out_mask: np.ndarray) -> None:
    """The dense path's files of frame `b` of a batch (evaluator.py:213-233
    of the JAX package): the overlay PNG and the .mat of its arrays."""
    os.makedirs(cat_dir, exist_ok=True)
    bgr = postprocess_image(out["input_image"][b])
    overlay = cv2.addWeighted(bgr, 0.5, postprocess_mask(out_mask), 0.4, 0)
    overlay = cv2.resize(overlay, (DES_WIDTH, DES_HEIGHT))
    cv2.imwrite(os.path.join(cat_dir, "frame_%08d.png" % frame_id), overlay)
    sio.savemat(os.path.join(cat_dir, "result_%d.mat" % frame_id), {
        "flow": out["gt_flow"][b],
        "img1": out["input_image"][b] + 0.5,
        "pred_mask": out_mask.astype(np.float64),
        "gt_mask": out["gt_masks"][b],
    })
