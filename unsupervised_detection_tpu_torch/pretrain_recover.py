"""Recover-net pretraining CLI of the port, counterpart of the JAX
package's pretrain_recover.py with the same flags:

    python -m unsupervised_detection_tpu_torch.pretrain_recover \\
        --root_dir=DAVIS --flow_ckpt=pwc/pwc-final --checkpoint_dir=recover \\
        --pretrain_steps=5000 ...

Flow inpainting of random box occlusions on the dataset's frame pairs,
against the flow of a frozen PWC net (train/pretrain.py). `--flow_ckpt`
is required (or `--allow_random_flow`); `--checkpoint_dir` receives the
scope saves `recover-<step>` and `recover-final`, which the train CLI
reads with `--recover_ckpt`. Extra flag: --pretrain_steps (default 5000).
Runs on the card; under torchrun each process trains on its rows of every
batch on its own card (`--mesh_data`, `--mesh_model`; parallel/mesh.py).
"""

from __future__ import annotations

import os
import sys

from .config import parse_flags
from .parallel.mesh import mesh_session
from .train.pretrain import pretrain_recover


def main(argv, device=None):
    """Run the CLI on `argv` (the flags, without the program name) on
    `device`: None is the card (cuda:LOCAL_RANK under torchrun), and raises
    without one. Returns the recover net (None on a rank outside the
    mesh)."""
    steps, flags = 5000, []
    for arg in argv:
        if arg.startswith("--pretrain_steps="):
            steps = int(arg.split("=", 1)[1])
        else:
            flags.append(arg)
    config = parse_flags(flags)
    with mesh_session(config, device) as mesh:
        if not mesh.member:
            return None
        if config.checkpoint_dir and mesh.is_main:
            os.makedirs(config.checkpoint_dir, exist_ok=True)
        return pretrain_recover(config, steps=steps, device=mesh.device, mesh=mesh)


if __name__ == "__main__":
    main(sys.argv[1:])
