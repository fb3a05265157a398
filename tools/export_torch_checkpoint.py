#!/usr/bin/env python3
"""Export a JAX checkpoint as a checkpoint of the PyTorch port.

    python tools/export_torch_checkpoint.py OUT.npz CKPT [PWC_CKPT]
    python tools/export_torch_checkpoint.py --train OUT.npz CKPT [PWC_CKPT]
    python tools/export_torch_checkpoint.py --scope=pwc_params OUT.npz CKPT
    python tools/export_torch_checkpoint.py --scope=rec_params OUT.npz CKPT

CKPT is an Orbax save of the JAX package: a full train state (what
train.py writes and test_generator.py's --ckpt_file restores), a game-arm
save, whose state holds no PWC weights (PWC_CKPT then names the PWC save:
pretrain_flow.py's bare scope save, or a full train state), or, with
--scope, a bare scope save (pretrain_flow.py's `pwc-final`,
pretrain_recover.py's `recover-final`) or a full state holding that scope.
OUT.npz is read with numpy alone
(unsupervised_detection_tpu_torch/train/checkpoint.py):

* by default an evaluation checkpoint: the generator's parameters and
  frozen statistics, the PWC parameters and search range, for
  `python -m unsupervised_detection_tpu_torch.test_generator --ckpt_file=OUT.npz`;
* with --train the whole train state besides (recover parameters, both
  Adam states, the step), for the port's train CLI's --full_model_ckpt
  and --resume_train. JAX's PRNG key is not exported: the port draws from
  its own torch.Generator;
* with --scope one net's parameters, for --flow_ckpt (pwc_params) and
  --recover_ckpt (rec_params).

Runs where JAX and Orbax are installed; the port itself needs neither.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TRAIN_FIELDS = ("gen_params", "gen_stats", "rec_params", "pwc_params", "gen_opt", "rec_opt",
                "step")
SCOPES = ("pwc_params", "rec_params")


def _restore(path: str) -> dict:
    import orbax.checkpoint as ocp

    if not os.path.isdir(path):
        raise IOError("Checkpoint file not found")
    return ocp.PyTreeCheckpointer().restore(os.path.abspath(path))


def restore_state(ckpt_file: str, pwc_ckpt: str | None = None) -> dict:
    """The train-state fields of CKPT as nested dicts of arrays, with the
    PWC weights taken from `pwc_ckpt` where given."""
    raw = _restore(ckpt_file)
    state = dict(raw["state"] if "state" in raw else raw)   # a game-arm save wraps its state
    if pwc_ckpt:
        pwc = _restore(pwc_ckpt)
        state["pwc_params"] = pwc.get("pwc_params", pwc)    # a full state holds it as a field
    if not state.get("pwc_params"):
        raise SystemExit(f"{ckpt_file} holds no PWC weights: name the PWC save as PWC_CKPT")
    return state


def export(out: str, ckpt_file: str, pwc_ckpt: str | None = None) -> str:
    from unsupervised_detection_tpu_torch.train.checkpoint import save_eval_checkpoint

    state = restore_state(ckpt_file, pwc_ckpt)
    return save_eval_checkpoint(out, state["gen_params"], state["gen_stats"],
                                state["pwc_params"])


def export_train(out: str, ckpt_file: str, pwc_ckpt: str | None = None) -> str:
    from unsupervised_detection_tpu_torch.train.checkpoint import save_trees

    state = restore_state(ckpt_file, pwc_ckpt)
    return save_trees(out, {k: state[k] for k in TRAIN_FIELDS})


def export_scope(out: str, ckpt_file: str, scope: str) -> str:
    from unsupervised_detection_tpu_torch.train.checkpoint import save_trees

    raw = _restore(ckpt_file)
    raw = raw.get("state", raw)
    tree = raw.get(scope, raw)                              # a full state holds it as a field
    return save_trees(out, {scope: tree})


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true", help="export the whole train state")
    ap.add_argument("--scope", choices=SCOPES, help="export one net's parameters")
    ap.add_argument("out")
    ap.add_argument("ckpt")
    ap.add_argument("pwc_ckpt", nargs="?")
    args = ap.parse_args(argv)
    if args.scope:
        if args.train or args.pwc_ckpt:
            ap.error("--scope takes OUT and CKPT only")
        path = export_scope(args.out, args.ckpt, args.scope)
    else:
        path = (export_train if args.train else export)(args.out, args.ckpt, args.pwc_ckpt)
    print(f"wrote {path} ({os.path.getsize(path) / 2**20:.1f} MiB)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
