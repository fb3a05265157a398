"""Batched evaluation, counterpart of
unsupervised_detection_tpu/eval/evaluator.py: `Evaluator.infer_metrics`,
`Evaluator.device_batch` and `evaluate_dataset` on its metrics-only path
(evaluator.py:145-257 with `fetch_dense` false). The dense path (`infer`:
the recover net's flows, overlays and .mat dumps) also needs the flow
colorizer and the visualizer, which the port does not have yet. One card,
no mesh."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..data import TestPipeline, get_reader
from ..data.device_input import DeviceFeeder
from ..device import precision_scope
from ..ops.metrics import eval_iou_mae
from ..ops.resize import central_crop_resize, resize_nearest
from ..train.objective import AdversarialObjective


class Evaluator:
    """Mask inference + IoU/MAE for one config on one device.

    `device=None` means the first CUDA device and raises without one. In
    float32 every call runs with TF32 off for cuDNN and matmul
    (`device.precision_scope`, entered per call and restored after).
    """

    def __init__(self, config: Config, device=None):
        self.config = config
        self.objective = AdversarialObjective(config, device)
        self.device = self.objective.device
        self.feeder = DeviceFeeder((config.reader_height, config.reader_width), self.device)

    def load_state_dicts(self, gen_state: dict, pwc_state: dict) -> None:
        self.objective.load_state_dicts(gen_state, pwc_state)

    def device_batch(self, batch):
        """Raw/host batch (a `TestPipeline` dict) -> reader-resolution
        (img1, img2, gt) on the device."""
        img1, img2 = self.feeder.images(batch)
        return img1, img2, self.feeder.mask(batch)

    @torch.inference_mode()
    def infer_metrics(self, img1: torch.Tensor, img2: torch.Tensor,
                      gt: torch.Tensor) -> dict[str, torch.Tensor]:
        """Per-frame IoU and MAE of the predicted masks.

        img1, img2: (B, reader_h, reader_w, 3) in [-0.5, 0.5]; gt: (B,
        reader_h, reader_w, 1). The reference order: central crop, PWC flow,
        working resize, mask, then the exact test_generator.py:19-40 metrics
        (the recover forward is skipped; it never enters the metrics).
        """
        cfg, obj = self.config, self.objective
        img1, img2, gt = (t.to(self.device) for t in (img1, img2, gt))
        with precision_scope(obj.dtype):
            if cfg.test_crop != 1.0:
                img1 = central_crop_resize(img1, cfg.test_crop)
                img2 = central_crop_resize(img2, cfg.test_crop)
                gt = central_crop_resize(gt, cfg.test_crop)
            flow = obj.compute_flow(img1, img2)
            image, flow = obj.resize_to_working(img1, flow)
            gt = resize_nearest(gt, (cfg.img_height, cfg.img_width))
            mask = obj.generate_mask(image, flow)
            iou_b, mae_b = eval_iou_mae(mask.float(), gt.float())
        return {"iou": iou_b, "mae": mae_b}


def build_test_pipeline(config: Config) -> TestPipeline:
    """The dataset's evaluation stream, as the JAX evaluate_dataset builds
    it: FBMS from its annotated test tuples (host mode), DAVIS2016 from the
    test partition (raw mode), SegTrack from all sequences (host mode)."""
    reader = get_reader(config.dataset, config.root_dir,
                        max_temporal_len=config.max_temporal_len,
                        min_temporal_len=config.min_temporal_len,
                        num_threads=1)
    reader_hw = (config.reader_height, config.reader_width)
    if config.dataset == "FBMS":
        tuples = reader.test_tuples(config.test_partition, config.test_temporal_shift)
        return TestPipeline(None, config.batch_size, config.test_temporal_shift,
                            reader_hw=reader_hw, raw_hw=None,
                            num_threads=config.num_threads, explicit_tuples=tuples)
    partition = config.test_partition if config.dataset == "DAVIS2016" else "all"
    ds = reader.dataset(partition)
    raw_hw = (reader.raw_height, reader.raw_width) if reader.raw_height is not None else None
    return TestPipeline(ds, config.batch_size, config.test_temporal_shift,
                        reader_hw=reader_hw, raw_hw=raw_hw, num_threads=config.num_threads)


def evaluate_dataset(config: Config, evaluator: Evaluator, save_dir: Optional[str] = None,
                     generate_visualization: bool = False, verbose: bool = True,
                     batches: Optional[Iterable[dict]] = None):
    """Full dataset evaluation with the weights loaded in `evaluator`;
    prints and returns the metrics (test_generator.py:42-132).

    The stream is built from `config` (`build_test_pipeline`) unless `batches`
    gives one: an iterable of `TestPipeline` batch dicts, for callers that
    feed frames without decoding files. Wrapped duplicates of the last batch
    count, in the frame count and in their category, as in the JAX loop.
    """
    if generate_visualization and save_dir:
        raise NotImplementedError(
            "--generate_visualization with --test_save_dir needs the dense path (the "
            "recover net's flows, the flow colorizer and the visualizer), which the "
            "PyTorch port does not have yet")
    if batches is None:
        batches = build_test_pipeline(config)

    category_iou: Dict[str, list] = {}
    category_mae: Dict[str, list] = {}
    i = 0
    for batch in batches:
        out = evaluator.infer_metrics(*evaluator.device_batch(batch))
        ious = out["iou"].cpu().numpy()
        maes = out["mae"].cpu().numpy()
        for b in range(ious.shape[0]):
            category = batch["category"][b]
            category_iou.setdefault(category, []).append(float(ious[b]))
            category_mae.setdefault(category, []).append(float(maes[b]))
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
