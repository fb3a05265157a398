"""Raw evaluation CLI of the port, counterpart of the JAX package's
test_generator.py with the same flag surface and summary lines:

    python -m unsupervised_detection_tpu_torch.test_generator \\
        --root_dir=DAVIS --ckpt_file=model.npz --pwc_search_range=2 ...

`--ckpt_file` is an evaluation checkpoint written by
tools/export_torch_checkpoint.py, a training save of the port
(`model.best`, `model-<epoch>`) as it is, or the prefix of a TF1 bundle of
the reference (its published models, or `train/tf1_export.py`'s), read
without TensorFlow. Prints per-category and dataset
IoU/MAE. With `--generate_visualization --test_save_dir=DIR` the dense path
also writes each frame's overlay PNG and `result_<n>.mat` under
DIR/<category>. Under torchrun each process evaluates its rows of every
batch on its own card (`--mesh_data`, `--mesh_model`; parallel/mesh.py):

    torchrun --standalone --nproc_per_node=N \
        -m unsupervised_detection_tpu_torch.test_generator ...
"""

from __future__ import annotations

import sys

from .config import parse_flags
from .eval import Evaluator, evaluate_dataset
from .parallel.mesh import mesh_session
from .train.checkpoint import load_eval_checkpoint


def main(argv, device=None) -> dict:
    """Run the CLI on `argv` (the flags, without the program name) on
    `device`: None is the card (cuda:LOCAL_RANK under torchrun), and raises
    without one. Returns the metrics dict of `evaluate_dataset` (None on a
    rank outside the mesh)."""
    config = parse_flags(argv)
    with mesh_session(config, device) as mesh:
        if not mesh.member:
            return None
        evaluator = Evaluator(config, mesh.device, mesh)
        evaluator.load_state_dicts(*load_eval_checkpoint(config.ckpt_file,
                                                         config.pwc_search_range))
        if mesh.is_main:
            print("Resume model from checkpoint {}".format(config.ckpt_file))
        return evaluate_dataset(config, evaluator, save_dir=config.test_save_dir or None,
                                generate_visualization=config.generate_visualization)


if __name__ == "__main__":
    main(sys.argv[1:])
