"""Multi-crop ensemble inference (the aug_test path), counterpart of
unsupervised_detection_tpu/eval/ensemble.py.

The reference builds four per-crop subgraphs at batch size 1
(build_aug_test_graph, adversarial_learner.py:525-592). As in the JAX
package the crop axis is a batch axis: the four central crop+resize
variants of a batch are concatenated into one 4B batch for a single PWC +
generator forward, and the outputs are split back per crop. On a mesh
(parallel/mesh.py) each rank runs the 4 crops of its rows of the batch and
`run` gathers the outputs over the data group in global order: the
4 crops x B forward splits over the data axis as JAX shards it
(ensemble.py:67-74 there).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..data.device_input import DeviceFeeder
from ..device import precision_scope
from ..ops.resize import central_crop_resize, resize_nearest
from ..parallel.mesh import Mesh
from ..train.objective import AdversarialObjective
from .evaluator import compute_iou_np, compute_mae_np

TEST_CROPS = [0.85, 0.9, 0.95, 1.0]  # adversarial_learner.py:531


class EnsembleEvaluator:
    """The 4-crop ensemble forward for one config on one device, on this
    rank's `mesh` (None: the trivial one).

    `device=None` means the first CUDA device and raises without one; float32
    runs with TF32 off (`device.precision_scope`). It ignores
    `config.test_crop`, as the JAX package does: the reference feeds
    test_crop=1.0 inputs and applies the crop grid
    (adversarial_learner.py:536-550)."""

    def __init__(self, config: Config, device=None, mesh: Mesh | None = None):
        self.config = config
        self.mesh = mesh if mesh is not None else Mesh()
        self.objective = AdversarialObjective(config, device, self.mesh)
        self.device = self.objective.device
        self.feeder = DeviceFeeder((config.reader_height, config.reader_width), self.device,
                                   self.mesh)

    def load_state_dicts(self, gen_state: dict, pwc_state: dict) -> None:
        self.objective.load_state_dicts(gen_state, pwc_state)

    @torch.inference_mode()
    def infer(self, img1: torch.Tensor, img2: torch.Tensor,
              gt: torch.Tensor) -> dict[str, torch.Tensor]:
        """(crops, B, ...) float32 tensors on the device: `pred_masks`,
        `gt_masks` (the gt cropped bilinearly, then resized nearest) and
        `img_1s` at the working resolution, from reader-resolution inputs
        as `Evaluator.infer_metrics` takes them."""
        cfg, obj = self.config, self.objective
        img1, img2, gt = (t.to(self.device) for t in (img1, img2, gt))
        b = img1.shape[0]
        with precision_scope(obj.dtype):
            img1_c = torch.cat([central_crop_resize(img1, c) for c in TEST_CROPS])
            img2_c = torch.cat([central_crop_resize(img2, c) for c in TEST_CROPS])
            gt_c = torch.cat([central_crop_resize(gt, c) for c in TEST_CROPS])
            flow = obj.compute_flow(img1_c, img2_c)
            image, flow = obj.resize_to_working(img1_c, flow)
            gt_w = resize_nearest(gt_c, (cfg.img_height, cfg.img_width))
            mask = obj.generate_mask(image, flow)

        def split(x):
            return x.float().reshape((len(TEST_CROPS), b) + tuple(x.shape[1:]))

        return {"pred_masks": split(mask), "gt_masks": split(gt_w), "img_1s": split(image)}

    def run(self, batch) -> Dict[str, np.ndarray]:
        """`infer` on one batch of uncropped test samples (a `TestPipeline`
        dict), as float32 numpy arrays: on a mesh, this rank's rows inferred
        and the global batch's gathered."""
        out = self.infer(*self.feeder.images(batch), self.feeder.mask(batch))
        return {k: self.mesh.gather_data(v, dim=1).cpu().numpy() for k, v in out.items()}


def crop_metrics(out: Dict[str, np.ndarray], b: int):
    """The reference's host metrics of sample `b` of a `run` output, per
    crop: (IoUs, MAEs, binary foreground masks) in crop order."""
    ious, maes, masks = [], [], []
    for ci in range(len(TEST_CROPS)):
        gt_mask = out["gt_masks"][ci, b]
        iou, out_mask = compute_iou_np(gt_mask=gt_mask, pred_mask_f=out["pred_masks"][ci, b])
        ious.append(iou)
        maes.append(compute_mae_np(gt_mask=gt_mask, pred_mask=out_mask))
        masks.append(out_mask)
    return ious, maes, masks
