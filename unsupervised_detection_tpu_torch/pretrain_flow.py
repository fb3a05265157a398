"""PWC flow-network pretraining CLI of the port, counterpart of the JAX
package's pretrain_flow.py with the same flags:

    python -m unsupervised_detection_tpu_torch.pretrain_flow \\
        --checkpoint_dir=pwc --pretrain_steps=20000 [--lr_schedule=cosine] ...

Supervised training on synthetic warped scenes, no data needed
(train/pretrain_pwc.py). `--checkpoint_dir` receives the scope saves
`pwc-<step>` and `pwc-final`, which the train CLI and `pretrain_recover`
read with `--flow_ckpt`. Extra flags: --pretrain_steps (default 20000),
--lr_schedule (constant|cosine, default constant). Runs on the card.
"""

from __future__ import annotations

import os
import sys

from .config import parse_flags
from .train.pretrain_pwc import pretrain_pwc


def main(argv, device=None):
    """Run the CLI on `argv` (the flags, without the program name) on
    `device`: None is the card, and raises without one. Returns (the PWC
    net, the final step's EPE)."""
    steps, lr_schedule, flags = 20000, "constant", []
    for arg in argv:
        if arg.startswith("--pretrain_steps="):
            steps = int(arg.split("=", 1)[1])
        elif arg.startswith("--lr_schedule="):
            lr_schedule = arg.split("=", 1)[1]
        else:
            flags.append(arg)
    config = parse_flags(flags)
    if config.checkpoint_dir:
        os.makedirs(config.checkpoint_dir, exist_ok=True)
    return pretrain_pwc(config, steps=steps, lr_schedule=lr_schedule, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
