"""PWC pretraining on the recipe's synthetic scenes, counterpart of the JAX
repo's tools/exp_pretrain_pwc.py (`main`, :52-133):

    python -m unsupervised_detection_tpu_torch.recipe.pretrain_pwc \\
        [steps] [batch] [H] [W] [ckpt_dir] [resume_ckpt] [scenes_version] \\
        [--device=cpu] [--dtype=float32|bfloat16]

with the tool's positional arguments and defaults (4000 8 192 384, ckpt_dir
exp_pwc_ckpt under the temporary directory, no resume, scenes v1) and its
knobs from the environment: PWC_OBJECT_WEIGHT (4.0), PWC_DEFORM_AMP (6.0,
scenes v3), PWC_BOUNDARY_WEIGHT (8.0, scenes v3), PWC_BOUNDARY_MODE
("final") and PWC_LR_SCHEDULE ("constant"). Scenes (recipe/scenes.py):

  v1  the game's scenes with pairs, square max(16, H/4); plain EPE loss;
  v2  1..3 rectangles with independent affine flows and photometric
      noise; pixels weigh 1 + PWC_OBJECT_WEIGHT x the objects' mask, and
      the progress line reports EPE inside the objects and in the
      background;
  v3  v2 with sinusoidal object-flow residuals of PWC_DEFORM_AMP px and
      the boundary band upweighted by PWC_BOUNDARY_WEIGHT.

The flagship's PWC came from recipe v2 (experiments/README.md):

    PWC_LR_SCHEDULE=cosine python -m unsupervised_detection_tpu_torch.recipe.pretrain_pwc \\
        16000 8 128 192 CKPT_DIR '' 2

Training is the port's `train/pretrain_pwc.pretrain_pwc` with this module's
`batch_fn` (search range 2, seed 0), so each step launches the cost
volume's and the warp's forward and backward kernels, plus one warp in the
scene render. Scenes are drawn from `torch.Generator(5)` (the tool's key
5). `resume_ckpt` (a PWC save) starts from its weights with the optimizer
moments restarted, as the tool does. `ckpt_dir` receives `pwc-<step>`
every 1000 steps and `pwc-final`, which the game's `pwc_ckpt`, the
diagnostic and `--flow_ckpt` read. Runs on the card unless `--device=cpu`
is given, and raises without a card otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from typing import Optional

import torch

from ..config import Config
from ..device import resolve_device
from ..models import PWCNet
from ..train import checkpoint as ckpt
from ..train.pretrain_pwc import pretrain_pwc
from .scenes import FLOW_SCALE, game_batch, v2_batch

SCENE_SEED = 5
SEARCH_RANGE = 2
SAVE_EVERY = 1000


@dataclasses.dataclass
class RecipeArgs:
    steps: int = 4000
    batch: int = 8
    height: int = 192
    width: int = 384
    ckpt_dir: str = ""
    resume: str = ""
    scenes: int = 1
    object_weight: float = 4.0       # PWC_OBJECT_WEIGHT (v2, v3)
    deform_amp: float = 0.0          # PWC_DEFORM_AMP (v3)
    boundary_weight: float = 0.0     # PWC_BOUNDARY_WEIGHT (v3)
    boundary_mode: str = "final"     # PWC_BOUNDARY_MODE
    lr_schedule: str = "constant"    # PWC_LR_SCHEDULE
    device: Optional[str] = None
    dtype: str = "float32"


def parse_args(argv, environ=None) -> RecipeArgs:
    """The tool's positional arguments and knobs, with the tool's
    version-dependent defaults: no object weight on v1, deform and
    boundary weight on v3 only."""
    environ = os.environ if environ is None else environ
    ap = argparse.ArgumentParser(
        prog="python -m unsupervised_detection_tpu_torch.recipe.pretrain_pwc",
        description=__doc__.split("\n\n")[0])
    for name, typ, default in (
            ("steps", int, 4000), ("batch", int, 8), ("height", int, 192),
            ("width", int, 384),
            ("ckpt_dir", str, os.path.join(tempfile.gettempdir(), "exp_pwc_ckpt")),
            ("resume", str, ""), ("scenes", int, 1)):
        ap.add_argument(name, nargs="?", type=typ, default=default)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU; the card by default")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    a = ap.parse_args(argv)
    v = a.scenes
    return RecipeArgs(
        steps=a.steps, batch=a.batch, height=a.height, width=a.width, ckpt_dir=a.ckpt_dir,
        resume=a.resume, scenes=v,
        object_weight=float(environ.get("PWC_OBJECT_WEIGHT", "4.0")) if v >= 2 else 0.0,
        deform_amp=float(environ.get("PWC_DEFORM_AMP", "6.0")) if v >= 3 else 0.0,
        boundary_weight=float(environ.get("PWC_BOUNDARY_WEIGHT", "8.0")) if v >= 3 else 0.0,
        boundary_mode=environ.get("PWC_BOUNDARY_MODE", "final"),
        lr_schedule=environ.get("PWC_LR_SCHEDULE", "constant"),
        device=a.device, dtype=a.dtype)


def scene_batches(args: RecipeArgs, device):
    """pretrain_pwc's `batch_fn`: the next batch of a generator seeded 5
    with flows in pixels, and the objects' mask on v2 and v3."""
    gen = torch.Generator().manual_seed(SCENE_SEED)

    def batch_fn(_rng, batch, h, w):
        if args.scenes >= 2:
            img1, img2, flow80, mask = v2_batch(gen, batch, h, w, args.deform_amp, device)
            return img1, img2, flow80 * FLOW_SCALE, mask
        img1, img2, flow80, _ = game_batch(gen, batch, h, w, max(16, h // 4),
                                           with_pairs=True, device=device)
        return img1, img2, flow80 * FLOW_SCALE

    return batch_fn


def run(args: RecipeArgs, log=print, verbose: bool = True):
    """Pretrain as the tool does; returns (the PWC net, final train EPE)."""
    device = resolve_device(args.device)
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
    log(f"pwc-pretrain on device scenes: steps={args.steps} batch={args.batch} "
        f"res={args.height}x{args.width} ckpt={args.ckpt_dir} scenes=v{args.scenes} "
        f"platform={device.type} dtype={args.dtype}")
    if args.scenes >= 3:
        log(f"v3 recipe: deform_amp={args.deform_amp} px, "
            f"boundary_weight={args.boundary_weight}")
    cfg = Config(batch_size=args.batch, reader_height=args.height, reader_width=args.width,
                 img_height=args.height, img_width=args.width, checkpoint_dir=args.ckpt_dir,
                 seed=0, pwc_search_range=SEARCH_RANGE, compute_dtype=args.dtype)
    params = None
    if args.resume:
        net = PWCNet(search_range=SEARCH_RANGE)
        ckpt.restore_params_scope(args.resume, net, "pwc_params")
        params = net.state_dict()
        log(f"resumed params from {args.resume}")
    net, epe = pretrain_pwc(cfg, steps=args.steps, verbose=verbose,
                            batch_fn=scene_batches(args, device), save_every=SAVE_EVERY,
                            params=params, lr_schedule=args.lr_schedule,
                            object_weight=args.object_weight,
                            boundary_weight=args.boundary_weight,
                            boundary_mode=args.boundary_mode, device=device)
    log(f"done: final train EPE {epe:.3f} px; checkpoint at "
        f"{os.path.join(args.ckpt_dir, 'pwc-final')}")
    return net, epe


def main(argv=None, environ=None, log=None):
    args = parse_args(sys.argv[1:] if argv is None else argv, environ)
    resolve_device(args.device)      # no card and no --device=cpu: raise now
    return run(args, log or (lambda line: print(line, flush=True)))


if __name__ == "__main__":
    main()
