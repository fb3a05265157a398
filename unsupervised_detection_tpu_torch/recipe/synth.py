"""The two-player game on given flow, with no PWC, counterpart of the JAX
repo's tools/exp_convergence_synth.py:

    python -m unsupervised_detection_tpu_torch.recipe.synth [cycles=400] [batch=8] \\
        [pretrain_steps=200] [--device=cpu]

Does the game converge to the moving object when the flow is exact? The
scenes (`make_batch`, the tool's :50-74, copied in numpy bit for bit) are
64x128 images with a textured 28-pixel square; the background carries a
smooth random affine flow, the square an independent one, so the
contextual-information-separation optimum is exactly the square. One
`np.random.RandomState(0)` stream feeds the warm start and then the
cycles in the tool's order; the validation batch is
`make_batch(RandomState(999), 16)`.

The steps are `recipe/game.py::Game`'s, at 64x128, float32, f=0.25:

  * the recover warm start (`pre_step`, the tool's :143-157): one random
    box per sample, inpainting under it, Charbonnier over H*W*B,
    per-element clip, TF1 Adam at the recover net's own count; then its
    Adam state is reset (:170);
  * cycles of 1 recover and 3 generator sub-steps (`sub_step`, :174-185):
    `losses_from_flow` on the scene's flow, clip, the generator's noise,
    TF1 Adam at the shared step;
  * every 25 cycles and at cycle 1 the tool's line: the disambiguated
    mask's IoU on the validation batch, its cover, the last sub-step's
    generator and recover losses (and the elapsed seconds); at the end
    `final IoU`.

No saves and no lock lever, as in the tool. `recipe.game_stats` reads the
console output. The nets' initial weights, the noise and the boxes come
from the port's `torch.Generator`s (`game.NET_SEED`, `game.MASK_SEED`),
not JAX's. Runs on the card unless `--device=cpu` is given, and raises
without a card otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .game import VAL_BATCH, VAL_EVERY, VAL_SEED, Game, GameArgs, deterministic_cudnn
from .scenes import FLOW_SCALE

H, W = 64, 128
SQUARE = 28
DATA_SEED = 0           # the tool's np.random.RandomState(0)
PRETRAIN_EVERY = 50     # the tool's warm-start print interval


def make_batch(rng: np.random.RandomState, batch: int):
    """(img, flow / 80, gt) as float32 NHWC numpy arrays, the tool's draws
    in its order: images with a textured square; the background flow a
    smooth random affine field (predictable from context, like camera
    motion), the square an independent affine field."""
    img = rng.rand(batch, H, W, 3).astype(np.float32) * 0.08 - 0.5
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    yy, xx = (yy - H / 2) / H, (xx - W / 2) / W
    flow = np.zeros((batch, H, W, 2), np.float32)
    gt = np.zeros((batch, H, W, 1), np.float32)
    for b in range(batch):
        y = rng.randint(0, H - SQUARE)
        x = rng.randint(0, W - SQUARE)
        img[b, y:y + SQUARE, x:x + SQUARE] += 0.35
        for ch in range(2):  # background: affine a + b*x + c*y
            a, bb, cc = rng.uniform(-6.0, 6.0), rng.uniform(-8, 8), rng.uniform(-8, 8)
            flow[b, :, :, ch] = a + bb * xx + cc * yy
        box = np.s_[y:y + SQUARE, x:x + SQUARE]
        for ch in range(2):  # square: independent affine
            a, bb, cc = rng.uniform(-12.0, 12.0), rng.uniform(-8, 8), rng.uniform(-8, 8)
            flow[b][box + (ch,)] = a + bb * xx[box] + cc * yy[box]
        gt[b][box] = 1.0
    return img, flow / FLOW_SCALE, gt


@dataclasses.dataclass
class SynthArgs:
    cycles: int = 400
    batch: int = 8
    pretrain: int = 200
    device: Optional[str] = None


def parse_args(argv) -> SynthArgs:
    """The tool's positional arguments, plus `--device`."""
    d = SynthArgs()
    ap = argparse.ArgumentParser(prog="python -m unsupervised_detection_tpu_torch.recipe.synth",
                                 description=__doc__.split("\n\n")[0])
    for name in ("cycles", "batch", "pretrain"):
        ap.add_argument(name, nargs="?", type=int, default=getattr(d, name))
    ap.add_argument("--device", default=None, help="cpu to run on the CPU; the card by default")
    a = ap.parse_args(argv)
    return SynthArgs(cycles=a.cycles, batch=a.batch, pretrain=a.pretrain, device=a.device)


def make_game(args: SynthArgs) -> Game:
    """The game's nets, Adam states and generators at the tool's size."""
    return Game(GameArgs(cycles=args.cycles, batch=args.batch, pretrain=args.pretrain,
                         height=H, width=W, device=args.device))


def to_device(arrays, device) -> tuple:
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def run(args: SynthArgs, log=print) -> dict:
    """The tool's main loop; prints its console lines through `log` and
    returns the run's record: "hist" [(cycle, IoU, cover)] (the final
    validation last), "seconds" {"pretrain", "cycles"} and "game"."""
    game = make_game(args)
    scope = deterministic_cudnn() if game.device.type == "cuda" else contextlib.nullcontext()
    with scope:
        return _loop(game, args, log)


def _loop(game: Game, args: SynthArgs, log) -> dict:
    cfg, dev = game.config, game.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    nprng = np.random.RandomState(DATA_SEED)
    t0 = time.time()
    for i in range(1, args.pretrain + 1):
        image, flow, _ = to_device(make_batch(nprng, args.batch), dev)
        ploss = game.pre_step(image, flow)
        if i % PRETRAIN_EVERY == 0:
            log(f"pretrain {i:4d}  inpaint loss {float(ploss):.4f}  ({time.time()-t0:.0f}s)")
    # a fresh recover Adam state for the adversarial phase
    game.end_warm_start()
    sync()
    t_pre = time.time() - t0

    val = to_device(make_batch(np.random.RandomState(VAL_SEED), VAL_BATCH), dev)
    hist, sub = [], 0
    cyc = cfg.iters_rec + cfg.iters_gen
    t1 = time.time()
    for cycle in range(1, args.cycles + 1):
        for _ in range(cyc):
            image, flow, _ = to_device(make_batch(nprng, args.batch), dev)
            player = "recover" if (sub % cyc) < cfg.iters_rec else "generator"
            losses = game.sub_step(player, image, flow)
            sub += 1
        if cycle % VAL_EVERY == 0 or cycle == 1:
            iou, mcov = game.validate(*val)
            hist.append((cycle, iou, mcov))
            log(f"cycle {cycle:4d}  IoU {iou:.3f}  mask-cover {mcov:.2f}  "
                f"gen {float(losses['generator']):+.4f}  "
                f"rec {float(losses['recover']):.4f}  ({time.time()-t0:.0f}s)")
    sync()
    t_cycles = time.time() - t1
    iou, mcov = game.validate(*val)
    hist.append((args.cycles, iou, mcov))
    log(f"final IoU {iou:.3f}")
    return {"hist": hist, "game": game, "seconds": {"pretrain": t_pre, "cycles": t_cycles}}


def main(argv=None, log=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    resolve_device(args.device)      # no card and no --device=cpu: raise now
    return run(args, log or (lambda line: print(line, flush=True)))


if __name__ == "__main__":
    main()
