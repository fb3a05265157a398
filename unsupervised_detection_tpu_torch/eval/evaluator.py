"""Batched evaluation, counterpart of
unsupervised_detection_tpu/eval/evaluator.py:66-123 (`infer_metrics` only:
`infer` and `evaluate_dataset` need the recover net and the data readers,
which come with later slices). One card, no mesh."""

from __future__ import annotations

import torch

from ..config import Config
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

    def load_state_dicts(self, gen_state: dict, pwc_state: dict) -> None:
        self.objective.load_state_dicts(gen_state, pwc_state)

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
