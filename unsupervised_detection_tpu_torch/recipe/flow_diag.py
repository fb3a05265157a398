"""Region-EPE diagnostic of a frozen PWC on the game's scenes, counterpart
of the JAX repo's tools/exp_flow_diag.py:

    python -m unsupervised_detection_tpu_torch.recipe.flow_diag \\
        [pwc_ckpt] [batch] [--seeds=999[,...]] [--device=cpu]

The EPE in pixels overall, inside the square (away from its edge), in the
+-4 px band around its edge and in the background (`region_masks`: a 9x9
dilation and erosion of the square, SAME-padded as `reduce_window` pads
with -inf), for the three paths that apply one frozen PWC (search range
2) to the game's scenes:

  native   scenes at 128x192 (square 32), PWC at 128x192;
  fullres  scenes at 192x384 (square 48), PWC at 192x384;
  divisor  scenes at 256x384 (square 64), PWC on the frames halved to
           128x192 (`flow_resolution_divisor=2`), flow x2 and resized to
           the working 192x384, against the scene's flow and square
           resized to 192x384 (the square thresholded at 0.5).

Beside them, the share of the square's pixels whose estimated flow is
closer to the square's own motion than to the background's ("did PWC see
the object", the question the tool's tail leaves open).

`pwc_ckpt` is anything the loaders take (default: the flagship's
committed export, weights_torch/flagship_v2lr_r2.npz). The scenes are
`recipe/scenes.py`'s, drawn from `torch.Generator(seed)` for each path (the
tool draws every path from its key 999); with several seeds, each seed's
lines and the spread over them. float32 with TF32 off. Runs on the card
unless `--device=cpu` is given, and raises without a card otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..device import precision_scope, resolve_device
from ..models import PWCNet
from ..ops.resize import resize_bilinear
from ..train import checkpoint as ckpt
from .scenes import FLOW_SCALE, game_draws, render_game

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT_FILE = os.path.join(REPO, "weights_torch", "flagship_v2lr_r2.npz")
SEARCH_RANGE = 2
VAL_SEED = 999       # the game's validation key
REGIONS = ("overall", "inside", "boundary", "background")
# path -> (scene = reader H, W, square, working H, W, divisor)
PATHS = {"native": (128, 192, 32, 128, 192, 1),
         "fullres": (192, 384, 48, 192, 384, 1),
         "divisor": (256, 384, 64, 192, 384, 2)}


def region_masks(gt: torch.Tensor, band_px: int = 4):
    """(inside, band, outside) bool masks from a (B, H, W, 1) {0, 1} mask:
    the band holds both classes within `band_px` (Chebyshev)."""
    x = gt.permute(0, 3, 1, 2)
    k = 2 * band_px + 1
    dil = F.max_pool2d(x, k, stride=1, padding=band_px).permute(0, 2, 3, 1)
    ero = -F.max_pool2d(-x, k, stride=1, padding=band_px).permute(0, 2, 3, 1)
    band = (dil > 0.5) & (ero < 0.5)
    return (gt > 0.5) & ~band, band, (gt <= 0.5) & ~band


def region_epe(est: torch.Tensor, flow: torch.Tensor, gt: torch.Tensor) -> dict:
    """EPE in the flows' units overall and by region; a region's mean is
    over its pixels (at least 1), as the tool's `report`."""
    err = torch.linalg.vector_norm(est.float() - flow.float(), dim=-1, keepdim=True)
    out = {"overall": float(err.mean())}
    for name, m in zip(REGIONS[1:], region_masks(gt)):
        m = m.float()
        out[name] = float((err * m).sum() / torch.clamp(m.sum(), min=1.0))
    return out


def seen_share(est: torch.Tensor, flow: torch.Tensor, bg_flow: torch.Tensor,
               gt: torch.Tensor) -> float:
    """Share of the square's pixels whose estimate is nearer the square's
    motion (`flow` there) than the background's."""
    near = (torch.linalg.vector_norm(est.float() - flow, dim=-1)
            < torch.linalg.vector_norm(est.float() - bg_flow, dim=-1))
    inside = gt[..., 0] > 0.5
    return float((near & inside).sum()) / max(float(inside.sum()), 1.0)


def line(name: str, r: dict) -> str:
    """The tool's report line."""
    return (f"{name:8s}  EPE px: overall {r['overall']:6.2f}  inside {r['inside']:6.2f}  "
            f"boundary {r['boundary']:6.2f}  background {r['background']:6.2f}")


def load_pwc(path: str, device) -> PWCNet:
    net = PWCNet(search_range=SEARCH_RANGE)
    ckpt.restore_params_scope(path, net, "pwc_params")
    return net.to(device).eval().requires_grad_(False)


def path_inputs(name: str, batch: int, seed: int, device):
    """The scenes of path `name` from `seed`'s draws: (img1, img2, flow px,
    background flow px, square), the last three at the working
    resolution."""
    sh, sw, square, wh, ww, _ = PATHS[name]
    draws = game_draws(torch.Generator().manual_seed(seed), batch, sh, sw, square)
    img1, img2, flow80, gt, bg80 = render_game(draws, sh, sw, square, with_pairs=True,
                                               device=device, background_flow=True)
    flow, bg = flow80 * FLOW_SCALE, bg80 * FLOW_SCALE
    if (wh, ww) != (sh, sw):
        flow, bg = resize_bilinear(flow, (wh, ww)), resize_bilinear(bg, (wh, ww))
        gt = (resize_bilinear(gt, (wh, ww)) > 0.5).to(torch.float32)
    return img1, img2, flow, bg, gt


@torch.no_grad()
def estimate(pwc: PWCNet, name: str, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PWC's flow of path `name` in reader pixels at the working
    resolution: the objective's float32 `compute_flow` and
    `resize_to_working` (train/objective.py), frames halved first and the
    flow doubled on the divisor path."""
    sh, sw, _, wh, ww, d = PATHS[name]
    with precision_scope(torch.float32):
        if d > 1:
            img1 = resize_bilinear(img1, (sh // d, sw // d))
            img2 = resize_bilinear(img2, (sh // d, sw // d))
        flow = pwc(img1, img2)
        if d > 1:
            flow = resize_bilinear(flow * d, (wh, ww))
    return flow


def diagnose(pwc: PWCNet, batch: int = 16, seed: int = VAL_SEED, device=None, log=print) -> dict:
    """{path: {overall, inside, boundary, background, seen}} for one seed."""
    device = resolve_device(device)
    out = {}
    for name in PATHS:
        img1, img2, flow, bg, gt = path_inputs(name, batch, seed, device)
        est = estimate(pwc, name, img1, img2)
        out[name] = {**region_epe(est, flow, gt), "seen": seen_share(est, flow, bg, gt)}
        log(line(name, out[name]))
    log("seen      share of square pixels nearer the square's motion than the background's: "
        + "  ".join(f"{n} {out[n]['seen']:.3f}" for n in PATHS))
    return out


def spread(results: dict) -> dict:
    """{path: {metric: (min, max, mean, standard deviation)}} over seeds
    (the deviation of a sample, ddof=1)."""
    out = {}
    for name in PATHS:
        out[name] = {}
        for key in REGIONS + ("seen",):
            v = np.array([r[name][key] for r in results.values()])
            out[name][key] = (float(v.min()), float(v.max()), float(v.mean()),
                              float(v.std(ddof=1)))
    return out


def _parser():
    ap = argparse.ArgumentParser(prog="python -m unsupervised_detection_tpu_torch.recipe.flow_diag",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("pwc_ckpt", nargs="?", default=CKPT_FILE)
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("--seeds", default=str(VAL_SEED), help="comma-separated scene seeds")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU; the card by default")
    return ap


def main(argv=None, log=None) -> dict:
    """Each seed's diagnostic ({seed: diagnose(...)}) and, with several
    seeds, "spread"."""
    a = _parser().parse_args(sys.argv[1:] if argv is None else argv)
    log = log or (lambda s: print(s, flush=True))
    device = resolve_device(a.device)   # no card and no --device=cpu: raise now
    log(f"flow diag: ckpt={a.pwc_ckpt} batch={a.batch} platform={device.type}")
    pwc = load_pwc(a.pwc_ckpt, device)
    results = {}
    for seed in (int(s) for s in a.seeds.split(",")):
        log(f"seed {seed}")
        results[seed] = diagnose(pwc, a.batch, seed, device, log)
    out = dict(results)
    if len(results) > 1:
        out["spread"] = spread(results)
        for name, metrics in out["spread"].items():
            log(f"spread {name:8s} over {len(results)} seeds (min / max / mean / std): "
                + "  ".join(f"{k} {lo:.2f} / {hi:.2f} / {mu:.2f} / {sd:.3f}"
                            for k, (lo, hi, mu, sd) in metrics.items()))
    log("done")
    return out


if __name__ == "__main__":
    main()
