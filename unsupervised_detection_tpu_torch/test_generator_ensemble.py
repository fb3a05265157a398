"""Multi-crop ensemble evaluation CLI of the port, counterpart of the JAX
package's test_generator_ensemble.py with the same flags, summary lines and
buffers:

    python -m unsupervised_detection_tpu_torch.test_generator_ensemble \\
        --root_dir=DAVIS --ckpt_file=model.npz --pwc_search_range=2 \\
        --test_temporal_shift=1 --generate_visualization \\
        --test_save_dir=buffer/davis_shift_1

Evaluates the 4 center crops {0.85, 0.9, 0.95, 1.0} of every frame in one
4B-batch forward and prints per-category and dataset IoU/MAE, each frame's
the mean over its crops. With `--generate_visualization --test_save_dir=DIR`
it writes DIR/<category>/result_<n>.mat with the keys img_1_XXX,
pred_mask_XXX and gt_mask_XXX per crop (XXX = 085, 090, 095, 100): the
buffers that `python -m unsupervised_detection_tpu_torch.post_processing`
reads. `--ckpt_file` is an evaluation checkpoint, a training save of the port
or a TF1 bundle's prefix. Runs on the card; under torchrun each process
runs the crops of its rows of every batch on its own card (`--mesh_data`,
`--mesh_model`; parallel/mesh.py), and global rank 0 prints and writes.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import scipy.io as sio

from .config import parse_flags
from .eval import TEST_CROPS, EnsembleEvaluator
from .eval.ensemble import crop_metrics
from .eval.evaluator import build_test_pipeline
from .parallel.mesh import mesh_session
from .train.checkpoint import load_eval_checkpoint


def main(argv, device=None) -> dict:
    """Run the CLI on `argv` (the flags, without the program name) on
    `device`: None is the card (cuda:LOCAL_RANK under torchrun), and raises
    without one. Returns {"dataset_iou", "dataset_mae", "category_iou",
    "category_mae", "frames"} (None on a rank outside the mesh)."""
    config = parse_flags(argv)
    with mesh_session(config, device) as mesh:
        if not mesh.member:
            return None
        evaluator = EnsembleEvaluator(config, mesh.device, mesh)
        evaluator.load_state_dicts(*load_eval_checkpoint(config.ckpt_file,
                                                         config.pwc_search_range))
        return _evaluate(config, evaluator)


def _evaluate(config, evaluator: EnsembleEvaluator) -> dict:
    mesh = evaluator.mesh
    log = print if mesh.is_main else (lambda *args: None)
    log("Resume model from checkpoint {}".format(config.ckpt_file))
    save = config.generate_visualization and config.test_save_dir and mesh.is_main
    category_iou, category_mae = {}, {}
    i = 0
    for batch in build_test_pipeline(config, mesh):
        out = evaluator.run(batch)
        for b in range(out["pred_masks"].shape[1]):
            category = batch["category"][b]
            cropped_iou, cropped_mae, out_masks = crop_metrics(out, b)
            # The crop mean for every frame, the first of a category too: the
            # reference seeds a new category with the last crop's values
            # instead (test_generator_ensemble.py:75-80 upstream), a bug the
            # JAX package fixes the same way.
            category_iou.setdefault(category, []).append(float(np.mean(cropped_iou)))
            category_mae.setdefault(category, []).append(float(np.mean(cropped_mae)))
            if save:
                save_dir = os.path.join(config.test_save_dir, category)
                os.makedirs(save_dir, exist_ok=True)
                matlab_out = {}
                for ci, crop in enumerate(TEST_CROPS):
                    key = "{:03d}".format(int(crop * 100))
                    matlab_out["img_1_" + key] = out["img_1s"][ci, b]
                    matlab_out["pred_mask_" + key] = out_masks[ci].astype(np.float64)
                    matlab_out["gt_mask_" + key] = out["gt_masks"][ci, b]
                sio.savemat(os.path.join(save_dir, "result_{}.mat".format(
                    len(category_iou[category]))), matlab_out)
            i += 1

    tot_ious = tot_maes = 0.0
    for cat, list_iou in category_iou.items():
        log("Category {}: IoU is {} and MAE is {}".format(
            cat, np.mean(list_iou), np.mean(category_mae[cat])))
        tot_ious += np.sum(list_iou)
        tot_maes += np.sum(category_mae[cat])
    log("The Average over the dataset: IoU is {} and MAE is {}".format(
        tot_ious / float(i), tot_maes / float(i)))
    log("Success: Processed {} frames".format(i))
    return {"dataset_iou": tot_ious / float(i), "dataset_mae": tot_maes / float(i),
            "category_iou": {k: float(np.mean(v)) for k, v in category_iou.items()},
            "category_mae": {k: float(np.mean(v)) for k, v in category_mae.items()},
            "frames": i}


if __name__ == "__main__":
    main(sys.argv[1:])
