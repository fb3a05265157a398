"""Adversarial training CLI of the port, counterpart of the JAX package's
train.py with the same flag surface:

    python -m unsupervised_detection_tpu_torch.train --root_dir=DAVIS \\
        --flow_ckpt=pwc.npz --checkpoint_dir=ckpt ...

Runs on the card; on several, data-parallel, under torchrun (one process
per card; `--mesh_data`, `--mesh_model` shape the mesh as in JAX,
parallel/mesh.py):

    torchrun --standalone --nproc_per_node=N \
        -m unsupervised_detection_tpu_torch.train --mesh_model=M ...

`--batch_size` is the global batch. `--flow_ckpt` (and `--recover_ckpt`, `--full_model_ckpt`)
name the port's `.npz` saves (train/checkpoint.py; tools/
export_torch_checkpoint.py writes them from JAX checkpoints); `--flow_ckpt`
and `--recover_ckpt` also take a TF1 bundle's prefix. With a
`--checkpoint_dir` and `tensorboardX` installed, TensorBoard summaries go
there too. `--seed`
seeds the nets' initial weights, the train pipeline's shuffle and the
torch.Generator of the augmentation and gradient-noise draws.
"""

from __future__ import annotations

import os
import pprint
import sys

from ..config import parse_flags
from ..parallel.mesh import mesh_session
from .driver import train


def main(argv, device=None):
    """Run the CLI on `argv` (the flags, without the program name) on
    `device`: None is the card (cuda:LOCAL_RANK under torchrun), and raises
    without one. Returns the final `TrainState` (None on a rank outside the
    mesh)."""
    config = parse_flags(argv)
    with mesh_session(config, device) as mesh:
        if not mesh.member:
            return None
        if mesh.is_main:
            pprint.PrettyPrinter().pprint(config.__dict__)
            if config.checkpoint_dir:
                os.makedirs(config.checkpoint_dir, exist_ok=True)
        return train(config, device=mesh.device, mesh=mesh)


if __name__ == "__main__":
    main(sys.argv[1:])
