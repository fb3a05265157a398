#!/usr/bin/env python3
"""Export a JAX checkpoint as an evaluation checkpoint of the PyTorch port.

    python tools/export_torch_checkpoint.py OUT.npz CKPT [PWC_CKPT]

CKPT is an Orbax save of the JAX package: either a full train state (what
train.py writes and test_generator.py's --ckpt_file restores) or a game-arm
save, whose state holds no PWC weights; PWC_CKPT then names the PWC save
(pretrain_flow.py's bare scope save, or a full train state). OUT.npz holds
the generator's parameters and frozen statistics, the PWC parameters and
the PWC search range (unsupervised_detection_tpu_torch/train/checkpoint.py),
and is read with numpy alone:

    python -m unsupervised_detection_tpu_torch.test_generator --ckpt_file=OUT.npz ...

Runs where JAX and Orbax are installed; the port itself needs neither.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _restore(path: str) -> dict:
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer().restore(os.path.abspath(path))


def restore_trees(ckpt_file: str, pwc_ckpt: str | None = None):
    """(gen_params, gen_stats, pwc_params) as nested dicts of arrays."""
    if not os.path.isdir(ckpt_file):
        raise IOError("Checkpoint file not found")
    raw = _restore(ckpt_file)
    state = raw["state"] if "state" in raw else raw     # a game-arm save wraps its state
    pwc = state["pwc_params"]
    if pwc_ckpt:
        pwc = _restore(pwc_ckpt)
        pwc = pwc.get("pwc_params", pwc)               # a full state holds it as a field
    if not pwc:
        raise SystemExit(f"{ckpt_file} holds no PWC weights: name the PWC save as PWC_CKPT")
    return state["gen_params"], state["gen_stats"], pwc


def export(out: str, ckpt_file: str, pwc_ckpt: str | None = None) -> str:
    from unsupervised_detection_tpu_torch.train.checkpoint import save_eval_checkpoint

    return save_eval_checkpoint(out, *restore_trees(ckpt_file, pwc_ckpt))


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    path = export(*argv)
    print(f"wrote {path} ({os.path.getsize(path) / 2**20:.1f} MiB)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
