"""Post-processing CLI of the port, counterpart of the JAX package's
post_processing.py with the same flags and output trees:

    python -m unsupervised_detection_tpu_torch.post_processing \\
        --path_buffer=buffer --flow_backend=pwc --flow_ckpt=pwc/pwc-final \\
        --pwc_search_range=2 --discover_sequences

buffer -> soft score (+ flow-propagated running averages) -> CRF at the
working resolution -> optional CRF at the original 854x480 resolution
(`--benchmark`). The buffer is what
`python -m unsupervised_detection_tpu_torch.test_generator_ensemble` writes
for the temporal shifts -2, -1, 1 and 2 (`<path_buffer>/davis_shift_<s>`).
`--flow_backend=pwc` runs the port's PWC net on the card (`--flow_ckpt`: a
PWC scope save or a training save of the port, or a TF1 bundle's prefix);
`auto` takes the native
pyflow solver where g++ builds it, else Farneback.
"""

from __future__ import annotations

import argparse
import os
import sys

from .postproc import crf, soft_score
from .postproc.propagate import pwc_flow_fn


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--path_buffer", default="/tmp/buffer_davis",
                        help="buffer from scripts/generate_buffer_DAVIS2016.sh")
    parser.add_argument("--out_soft_score", default="./soft_davis")
    parser.add_argument("--resized_out", default="./crf_resized_davis")
    parser.add_argument("--original_out", default="./crf_original_davis")
    parser.add_argument("--benchmark", action="store_true",
                        help="also run CRF at the original 854x480 resolution")
    parser.add_argument("--path_img", default="./DAVIS/JPEGImages/480p")
    parser.add_argument("--path_gt", default="./DAVIS/Annotations/480p")
    parser.add_argument("--flow_backend", default="auto",
                        choices=["auto", "pyflow", "farneback", "pwc"],
                        help="flow used for mask propagation; auto prefers "
                             "the native pyflow module when it builds; pwc runs "
                             "the port's own flow net on the card "
                             "(requires --flow_ckpt)")
    parser.add_argument("--flow_ckpt", default="",
                        help="PWC scope save or training save of the port, or "
                             "a TF1 bundle's prefix, for --flow_backend=pwc")
    parser.add_argument("--pwc_search_range", type=int, default=4,
                        help="cost-volume search range the --flow_ckpt was "
                             "trained with (pretrain_flow's --pwc_search_range)")
    parser.add_argument("--sxy", type=float, default=25.0)
    parser.add_argument("--srgb", type=float, default=5.0)
    parser.add_argument("--scomp", type=float, default=5.0)
    parser.add_argument("--gauss_k", type=float, default=0.1)
    parser.add_argument("--discover_sequences", action="store_true",
                        help="derive sequence names/lengths from the buffer "
                             "tree instead of the hardcoded DAVIS val list")
    return parser


def main(argv, device=None) -> dict:
    """Run the CLI on `argv` (the flags, without the program name);
    `--flow_backend=pwc` runs on `device` (None is the card, and raises
    without one). Returns {"iou_resized": ..., "iou_original": ... or None}."""
    args = _parser().parse_args(argv)

    flow_backend = args.flow_backend
    if flow_backend == "auto":
        from .native import pyflow

        try:
            pyflow.library()
            flow_backend = "pyflow"
        except (OSError, RuntimeError):
            flow_backend = "farneback"
    elif flow_backend == "pwc":
        if not args.flow_ckpt:
            raise SystemExit("--flow_backend=pwc requires --flow_ckpt")
        flow_backend = pwc_flow_fn(args.flow_ckpt, search_range=args.pwc_search_range,
                                   device=device)
    print("Propagation flow backend: {}".format(
        args.flow_backend if callable(flow_backend) else flow_backend))

    seq_names = seq_num = None
    if args.discover_sequences:
        shift_dir = os.path.join(args.path_buffer, "davis_shift_1")
        seq_names = sorted(os.listdir(shift_dir))
        seq_num = [
            len([f for f in os.listdir(os.path.join(shift_dir, s)) if f.endswith(".mat")])
            for s in seq_names
        ]
        print("Discovered sequences:", dict(zip(seq_names, seq_num)))

    os.makedirs(args.out_soft_score, exist_ok=True)
    soft_score.buffer_to_soft_score(buffer_path=args.path_buffer,
                                    out_path=args.out_soft_score,
                                    seq_names=seq_names, seq_num=seq_num,
                                    flow_fn=flow_backend)

    os.makedirs(args.resized_out, exist_ok=True)
    iou_resized = crf.run_crf(args.out_soft_score, args.sxy, args.srgb,
                              args.scomp, args.gauss_k, out_path=args.resized_out)
    print("iou of the resized version:")
    print(iou_resized)

    iou_original = None
    if args.benchmark:
        os.makedirs(args.original_out, exist_ok=True)
        iou_original = crf.run_crf_original_resolution(
            args.resized_out, args.path_img, args.path_gt,
            60.0, args.srgb, args.scomp, args.gauss_k, args.original_out,
        )
        print("iou of the original resolution version:")
        print(iou_original)
    return {"iou_resized": iou_resized, "iou_original": iou_original}


if __name__ == "__main__":
    main(sys.argv[1:])
