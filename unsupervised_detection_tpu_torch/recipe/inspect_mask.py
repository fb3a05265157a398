"""What a game's generator masks, sample by sample, counterpart of the JAX
repo's tools/exp_inspect_game_mask.py:

    python -m unsupervised_detection_tpu_torch.recipe.inspect_mask <game_ckpt> <pwc_ckpt> \\
        [H=192 W=384 batch=16] [--device=cpu]

`game_ckpt` is any generator save the port writes: `recipe.game`'s
`model.best` or `model-<cycle>`, a training save, an evaluation `.npz`
(`weights_torch/flagship_v2lr_r2.npz`) or a generator-only `.npz`
(`weights_torch/game_card_fp32_best_gen.npz`). `pwc_ckpt` is any PWC the
loaders take (a scope save, a training save, an evaluation `.npz`, a TF1
prefix), at search range 2.

The batch is the game's fixed validation batch (`scenes.game_draws` seeded
`game.VAL_SEED`, with pairs, square max(16, H/4)); the frozen PWC's flow
of the warped pair, resized to the working resolution, goes through the
generator. The raw mask is thresholded at 0.5 (not disambiguated) and
held against the square: per sample the IoU, the mask's area, the share
of the mask inside the square, the distance of the mask's centroid from
the square's, and the mask's connected components (`scipy.ndimage.label`,
4-connectivity; -1 without scipy). Enough to tell a lock on the square
from one on its complement, a misplaced lock or a fragmented attractor.
Runs on the card unless `--device=cpu` is given, and raises without a
card otherwise.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from ..convert import generator_state_dict
from ..device import precision_scope, resolve_device
from ..train.checkpoint import load_trees
from .game import VAL_SEED, Game, GameArgs
from .scenes import game_draws

HEADER = "  b   IoU  area%  in-gt%  d-centroid  ncomp"


def load_generator(path: str, net: torch.nn.Module) -> dict:
    """Load the generator of a port save into `net` in place; returns the
    save's `cycle` and `best` where it records them."""
    trees = load_trees(path)
    if not trees.get("gen_params"):
        raise ValueError(f"{path}: holds no gen_params")
    net.load_state_dict(generator_state_dict(trees["gen_params"], trees.get("gen_stats")))
    return {k: trees[k].item() for k in ("cycle", "best") if k in trees}


def mask_geometry(mask: np.ndarray, gt: np.ndarray) -> list:
    """Per sample of the (B, H, W) boolean masks and squares: {"iou",
    "area", "in_gt", "dist" (px, nan for an empty mask), "ncomp"}."""
    try:
        from scipy import ndimage
    except ImportError:
        ndimage = None
    rows = []
    for m, g in zip(mask, gt):
        inter, union, n = (m & g).sum(), (m | g).sum(), m.sum()
        gy, gx = np.argwhere(g).mean(axis=0)
        if n:
            my, mx = np.argwhere(m).mean(axis=0)
            dist = float(np.hypot(my - gy, mx - gx))
        else:
            dist = float("nan")
        rows.append({"iou": float(inter / union) if union else 0.0, "area": float(m.mean()),
                     "in_gt": float(inter / max(n, 1)), "dist": dist,
                     "ncomp": int(ndimage.label(m)[1]) if ndimage is not None else -1})
    return rows


def table(rows: list) -> list:
    """The tool's table lines and its mean IoU line."""
    out = [HEADER]
    for b, r in enumerate(rows):
        out.append(f"{b:3d}  {r['iou']:.3f}  {100 * r['area']:5.1f}  {100 * r['in_gt']:5.1f}"
                   f"  {r['dist']:9.1f}  {r['ncomp']:5d}")
    out.append(f"mean IoU {np.mean([r['iou'] for r in rows]):.3f}")
    return out


def inspect(game_ckpt: str, pwc_ckpt: str, height: int = 192, width: int = 384,
            batch: int = 16, device=None, draws: Optional[dict] = None, log=print) -> dict:
    """Run the frozen PWC and the generator of `game_ckpt` on the
    validation batch (or on `draws`, `scenes.game_draws` of another
    source) and print the table through `log`. Returns {"rows", "mean_iou",
    "mask" (the raw mask, on the device), "saved" (cycle and best)}."""
    game = Game(GameArgs(batch=batch, height=height, width=width, pwc_ckpt=pwc_ckpt,
                         device=device))
    saved = load_generator(game_ckpt, game.state.generator)
    if saved:
        log(f"loaded {game_ckpt} at cycle {saved.get('cycle', 0)} "
            f"(best {saved.get('best', 0.0):.3f})")
    else:
        log(f"loaded {game_ckpt} (it records no cycle)")
    if draws is None:
        draws = game_draws(torch.Generator().manual_seed(VAL_SEED), batch, height, width,
                           game.args.side)
    image, flow, gt = game.inputs(draws)[:3]
    with torch.no_grad(), precision_scope(game.dtype):
        mask = game.objective.generate_mask(image, flow)
    rows = mask_geometry(mask[..., 0].cpu().numpy() > 0.5, gt[..., 0].cpu().numpy() > 0.5)
    for line in table(rows):
        log(line)
    return {"rows": rows, "mean_iou": float(np.mean([r["iou"] for r in rows])), "mask": mask,
            "saved": saved}


def parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m unsupervised_detection_tpu_torch.recipe.inspect_mask",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("game_ckpt")
    ap.add_argument("pwc_ckpt")
    ap.add_argument("height", nargs="?", type=int, default=192)
    ap.add_argument("width", nargs="?", type=int, default=384)
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU; the card by default")
    return ap.parse_args(argv)


def main(argv=None, log=None) -> dict:
    a = parse_args(sys.argv[1:] if argv is None else argv)
    resolve_device(a.device)      # no card and no --device=cpu: raise now
    return inspect(a.game_ckpt, a.pwc_ckpt, a.height, a.width, a.batch, a.device,
                   log=log or (lambda line: print(line, flush=True)))


if __name__ == "__main__":
    main()
