"""The synthetic two-player game that trained the flagship detector,
counterpart of the JAX repo's tools/exp_convergence_v2.py (`main`,
:137-384):

    python -m unsupervised_detection_tpu_torch.recipe.game \\
        [cycles] [batch] [pretrain] [f] [H] [W] [pwc_ckpt] [state_dir] \\
        [--device=cpu] [--dtype=float32|bfloat16]

with the tool's positional arguments and defaults (2000 16 500 0.25 192
384, ground-truth flow without `pwc_ckpt`) and its knobs from the
environment: EXP_SQUARE (the square's side, default max(16, H/4)),
EXP_SAVE_EVERY (250), EXP_POSTLOCK_LR (1.0), EXP_LOCK_IOU (0.45),
EXP_LOCK_COVER (0.12). The flagship's recipe is

    EXP_POSTLOCK_LR=0.3 python -m unsupervised_detection_tpu_torch.recipe.game \\
        7000 16 500 0.25 192 384 weights_torch/flagship_v2lr_r2.npz STATE_DIR

Scenes are `recipe/scenes.py`'s game scenes at the working resolution
(reader = working). With `pwc_ckpt` (any PWC the loaders take: a scope
save, a training save, an evaluation `.npz`, a TF1 prefix; search range 2)
the frozen PWC estimates the flow of the warped pair, resized to the
working resolution as the objective does; else the scene's own flow is
fed. Then, as the tool:

  * the recover warm start (`pre_step`, :229-245): one random box per
    sample, the recover net inpaints the flow under it, Charbonnier over
    H*W*B, per-element clip, TF1 Adam at the recover net's own count; its
    Adam state is reset afterwards (:322-323);
  * cycles of 1 recover and 3 generator sub-steps (`sub_step`, :192-222):
    `losses_from_flow` on the precomputed flow (no augmentation, no PWC in
    the step), then train/learner.py::apply_update -- clip, the
    generator's noise, TF1 Adam at the shared step with lr * lr_scale;
  * every 25 cycles (and at cycle 1) the disambiguated mask's IoU and its
    cover on the fixed validation batch (seed 999, batch 16); with a PWC,
    the frozen PWC's EPE on it first (:325-334);
  * `model.best` on every improvement (best starts at -1, so the first
    validation writes it): the evaluation trees, so `test_generator
    --ckpt_file` and `e2e_jmean --ckpt_file` read it as they read the
    flagship, with the loop's counters;
  * `model-<cycle>` every EXP_SAVE_EVERY cycles: both nets, both Adam
    states, every torch.Generator's state (the scenes', the boxes', the
    noise's), the cycle, best and lr_scale, and no PWC; a run with the
    same state_dir resumes from the latest and replays the uninterrupted
    run's stream bit for bit (cuDNN runs its deterministic algorithms);
  * the lock detector and the post-lock LR lever (:367-376) and the final
    verdict (:377-384).

Console lines keep the tool's format, so a log of the port sits beside
the JAX one line by line. The random draws are the port's own
(`torch.Generator`s seeded as the tool's keys: 8964 for the nets'
initial weights and the noise, 1234 for the scenes, 7 for the boxes, 999
for the validation batch), not JAX's. Runs on the card unless
`--device=cpu` is given, and raises without a card otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import precision_scope, resolve_device
from ..models import RecoverNet
from ..ops.metrics import compute_all_iou
from ..train import checkpoint as ckpt
from ..train.learner import TrainState, apply_update
from ..train.objective import AdversarialObjective
from ..train.optim import adam_apply, adam_init
from ..train.pretrain import inpainting_loss, random_box_masks, sample_box_draws
from .scenes import game_draws, render_game

NET_SEED, DATA_SEED, MASK_SEED, VAL_SEED = 8964, 1234, 7, 999
VAL_BATCH = 16
VAL_EVERY = 25
DEFAULT_F = 0.25


@dataclasses.dataclass
class GameArgs:
    cycles: int = 2000
    batch: int = 16
    pretrain: int = 500
    f: float = DEFAULT_F
    height: int = 192
    width: int = 384
    pwc_ckpt: str = ""
    state_dir: str = ""
    square: int = 0              # EXP_SQUARE; 0: max(16, H // 4)
    save_every: int = 250        # EXP_SAVE_EVERY
    postlock_lr: float = 1.0     # EXP_POSTLOCK_LR
    lock_iou: float = 0.45       # EXP_LOCK_IOU
    lock_cover: float = 0.12     # EXP_LOCK_COVER
    device: Optional[str] = None
    dtype: str = "float32"

    @property
    def side(self) -> int:
        return self.square or max(16, self.height // 4)


def parse_args(argv, environ=None) -> GameArgs:
    """The tool's positional arguments and environment knobs, plus
    `--device` and `--dtype`."""
    environ = os.environ if environ is None else environ
    d = GameArgs()
    ap = argparse.ArgumentParser(prog="python -m unsupervised_detection_tpu_torch.recipe.game",
                                 description=__doc__.split("\n\n")[0])
    for name, typ in (("cycles", int), ("batch", int), ("pretrain", int), ("f", float),
                      ("height", int), ("width", int), ("pwc_ckpt", str), ("state_dir", str)):
        ap.add_argument(name, nargs="?", type=typ, default=getattr(d, name))
    ap.add_argument("--device", default=None, help="cpu to run on the CPU; the card by default")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    a = ap.parse_args(argv)
    return GameArgs(
        cycles=a.cycles, batch=a.batch, pretrain=a.pretrain, f=a.f, height=a.height,
        width=a.width, pwc_ckpt=a.pwc_ckpt, state_dir=a.state_dir,
        square=int(environ.get("EXP_SQUARE", "0")),
        save_every=int(environ.get("EXP_SAVE_EVERY", "250")),
        postlock_lr=float(environ.get("EXP_POSTLOCK_LR", "1.0")),
        lock_iou=float(environ.get("EXP_LOCK_IOU", "0.45")),
        lock_cover=float(environ.get("EXP_LOCK_COVER", "0.12")),
        device=a.device, dtype=a.dtype)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms within the scope (a resumed run
    replays the uninterrupted one bit for bit); restored on exit."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


class Game:
    """The game's nets, Adam states and generators on one device. Initial
    weights come from NET_SEED (the learner's initialisation); the PWC
    from `args.pwc_ckpt`."""

    def __init__(self, args: GameArgs):
        self.args = args
        self.device = resolve_device(args.device)
        h, w = args.height, args.width
        self.config = Config(img_height=h, img_width=w, reader_height=h, reader_width=w,
                             batch_size=args.batch, compute_dtype=args.dtype,
                             allow_random_flow=True, seed=NET_SEED,
                             pwc_search_range=2 if args.pwc_ckpt else 4)
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(NET_SEED)
            obj = AdversarialObjective(self.config, self.device)
            if args.f != DEFAULT_F:
                obj.recover = RecoverNet(f=args.f, dtype=obj.dtype).to(self.device).eval()
        self.objective, self.dtype = obj, obj.dtype
        for net in (obj.generator, obj.recover, obj.pwc):
            net.requires_grad_(False)
        if args.pwc_ckpt:
            ckpt.restore_params_scope(args.pwc_ckpt, obj.pwc, "pwc_params")
        cfg = self.config
        self.adam_hparams = (cfg.learning_rate, cfg.beta1, 0.999, cfg.adam_epsilon)
        self.state = TrainState(
            step=0, rng=torch.Generator().manual_seed(NET_SEED), generator=obj.generator,
            recover=obj.recover, pwc=obj.pwc,
            gen_opt=adam_init(dict(obj.generator.named_parameters())),
            rec_opt=adam_init(dict(obj.recover.named_parameters())))
        self.data_rng = torch.Generator().manual_seed(DATA_SEED)
        self.mask_rng = torch.Generator().manual_seed(MASK_SEED)

    # --- data -------------------------------------------------------------
    def inputs(self, draws: dict):
        """(image, flow / 80, gt) at the working resolution from
        `scenes.game_draws` draws: the scene's flow, or the frozen PWC's on
        the warped pair. With a PWC, also the scene's flow / 80 last."""
        a = self.args
        if not a.pwc_ckpt:
            return render_game(draws, a.height, a.width, a.side, device=self.device)
        img1, img2, flow80, gt = render_game(draws, a.height, a.width, a.side,
                                             with_pairs=True, device=self.device)
        with precision_scope(self.dtype):
            flow = self.objective.compute_flow(img1, img2)
            image, flow = self.objective.resize_to_working(img1, flow)
        return image, flow, gt, flow80

    def next_batch(self, gen: Optional[torch.Generator] = None, batch: Optional[int] = None):
        """`inputs` of the next draws of `gen` (the scenes' generator)."""
        a = self.args
        draws = game_draws(gen or self.data_rng, batch or a.batch, a.height, a.width, a.side)
        return self.inputs(draws)

    # --- steps ------------------------------------------------------------
    def pre_step(self, image: torch.Tensor, flow: torch.Tensor,
                 box_draws: Optional[dict] = None) -> torch.Tensor:
        """One recover warm-start update on the boxes of `box_draws`
        (default: drawn from the boxes' generator); returns the loss."""
        cfg, state = self.config, self.state
        if box_draws is None:
            box_draws = sample_box_draws(self.mask_rng, image.shape[0])
        mask = random_box_masks(box_draws, cfg.img_height, cfg.img_width, device=self.device)
        params = dict(state.recover.named_parameters())
        with precision_scope(self.dtype):
            state.recover.requires_grad_(True)
            try:
                loss = inpainting_loss(state.recover, image, flow, mask, cfg.cbn)
                grads = torch.autograd.grad(loss, list(params.values()))
            finally:
                state.recover.requires_grad_(False)
        grads = [g.clamp(-cfg.gradient_clip, cfg.gradient_clip) for g in grads]
        state.rec_opt = adam_apply(dict(zip(params, grads)), state.rec_opt, params,
                                   state.rec_opt.count + 1, *self.adam_hparams)
        return loss.detach()

    def end_warm_start(self) -> None:
        """Reset the recover net's Adam state (the tool's :322-323)."""
        self.state.rec_opt = adam_init(dict(self.state.recover.named_parameters()))

    def sub_step(self, player: str, image: torch.Tensor, flow: torch.Tensor,
                 lr_scale: float = 1.0) -> dict:
        """One update of `player` ("recover" or "generator") on the
        precomputed flow; returns the 8 losses before it."""
        state = self.state
        net = state.recover if player == "recover" else state.generator
        params = dict(net.named_parameters())
        with precision_scope(self.dtype):
            net.requires_grad_(True)
            try:
                out = self.objective.losses_from_flow(image, flow)
                grads = torch.autograd.grad(out.losses[player], list(params.values()))
            finally:
                net.requires_grad_(False)
        opt = "rec_opt" if player == "recover" else "gen_opt"
        _, losses, _ = apply_update(state, params, grads, out.losses, opt,
                                    player == "generator", self.config, self.adam_hparams,
                                    lr_scale=lr_scale)
        return losses

    @torch.no_grad()
    def validate(self, image: torch.Tensor, flow: torch.Tensor, gt: torch.Tensor):
        """(mean IoU of the disambiguated masks, mean mask cover)."""
        with precision_scope(self.dtype):
            mask = self.objective.generate_mask(image, flow).float()
        return float(compute_all_iou(mask, gt).mean()), float(mask.mean())

    # --- saves ------------------------------------------------------------
    def save(self, name: str, cycle: int, best: float, lr_scale: float) -> str:
        """`model.best` (the evaluation trees and the counters) or a
        resume point `model-<cycle>` (both nets and Adam states, every
        generator, the counters; no PWC)."""
        self.state.step = cycle
        trees = ckpt.train_trees(self.state)
        extra = {"cycle": np.int32(cycle), "best": np.float32(best),
                 "lr_scale": np.float32(lr_scale)}
        if name == ckpt.BEST_NAME:
            trees = {k: trees[k] for k in ckpt.TREES + ("step",)}
        else:
            del trees["pwc_params"]
            extra.update(data_rng=self.data_rng.get_state().numpy(),
                         mask_rng=self.mask_rng.get_state().numpy())
        path = os.path.join(self.args.state_dir, name)
        return ckpt.save_trees(os.path.abspath(path), {**trees, **extra})

    def resume(self, path: str):
        """Load a `model-<cycle>` save; returns (cycle, best, lr_scale)."""
        trees = ckpt.load_trees(path)
        ckpt.load_train_state(self.state, trees)
        self.data_rng.set_state(torch.from_numpy(trees["data_rng"]))
        self.mask_rng.set_state(torch.from_numpy(trees["mask_rng"]))
        return int(trees["cycle"]), float(trees["best"]), float(trees["lr_scale"])


def run(args: GameArgs, log=print) -> dict:
    """The tool's main loop; prints its console lines through `log` and
    returns the run's record: "hist" [(cycle, IoU, cover)], "epe" (with a
    PWC), "seconds" {"pretrain", "cycles"}, "cycles_run" and "game" (the
    `Game`, its state after the last cycle)."""
    game = Game(args)
    a = args
    log(f"config: cycles={a.cycles} batch={a.batch} pretrain={a.pretrain} "
        f"f={a.f} res={a.height}x{a.width} square={a.side} "
        f"flow={'pwc:' + a.pwc_ckpt if a.pwc_ckpt else 'ground-truth'} "
        f"platform={game.device.type} dtype={a.dtype}")
    scope = deterministic_cudnn() if game.device.type == "cuda" else contextlib.nullcontext()
    with scope:
        return _loop(game, log)


def _loop(game: Game, log) -> dict:
    a, cfg = game.args, game.config
    start_cycle, best, lr_scale = 1, -1.0, 1.0
    pretrain_steps, resume_path = a.pretrain, None
    if a.state_dir:
        os.makedirs(a.state_dir, exist_ok=True)
        resume_path = ckpt.latest_checkpoint(a.state_dir)
    if resume_path:
        cycle, best, lr_scale = game.resume(resume_path)
        start_cycle = cycle + 1
        pretrain_steps = 0   # the recover warm start is inside the saved state
        log(f"resumed from {resume_path} at cycle {start_cycle} "
            f"(best {best:.3f}, lr_scale {lr_scale:g})")

    sync = torch.cuda.synchronize if game.device.type == "cuda" else (lambda: None)
    t0 = time.time()
    for i in range(1, pretrain_steps + 1):
        image, flow = game.next_batch()[:2]
        ploss = game.pre_step(image, flow)
        if i % 100 == 0:
            log(f"pretrain {i:5d}  inpaint loss {float(ploss):.4f}  "
                f"({time.time()-t0:.0f}s)")
    if not resume_path:
        game.end_warm_start()
    sync()
    t_pre = time.time() - t0

    val = game.next_batch(torch.Generator().manual_seed(VAL_SEED), VAL_BATCH)
    val_img, val_flow, val_gt = val[:3]
    record = {"hist": [], "epe": None}
    if a.pwc_ckpt:
        epe = float(torch.linalg.vector_norm((val_flow.float() - val[3]) * cfg.flow_normalizer,
                                             dim=-1).mean())
        record["epe"] = epe
        log(f"frozen-PWC flow quality on val batch: EPE {epe:.2f} px")

    cyc = cfg.iters_rec + cfg.iters_gen
    sub, locked_votes, losses = 0, 0, None
    t1 = time.time()
    for cycle in range(start_cycle, a.cycles + 1):
        for _ in range(cyc):
            image, flow = game.next_batch()[:2]
            player = "recover" if (sub % cyc) < cfg.iters_rec else "generator"
            losses = game.sub_step(player, image, flow, lr_scale)
            sub += 1
        if cycle % VAL_EVERY == 0 or cycle == 1:
            iou, mcov = game.validate(val_img, val_flow, val_gt)
            if iou > best:
                best = iou
                if a.state_dir:
                    game.save(ckpt.BEST_NAME, cycle, best, lr_scale)
            record["hist"].append((cycle, iou, mcov))
            log(f"cycle {cycle:5d}  IoU {iou:.3f}  "
                f"mask-cover {mcov:.2f}  "
                f"gen {float(losses['generator']):+.4f}  "
                f"rec {float(losses['recover']):.4f}  "
                f"({time.time()-t0:.0f}s)")
            if a.postlock_lr != 1.0 and lr_scale == 1.0:
                locked_votes = (locked_votes + 1
                                if iou > a.lock_iou and mcov < a.lock_cover else 0)
                if locked_votes >= 2:
                    lr_scale = a.postlock_lr
                    log(f"cycle {cycle:5d}  LOCK detected (2 consecutive "
                        f"vals IoU > {a.lock_iou}, cover < {a.lock_cover}) — "
                        f"lr scaled x{a.postlock_lr:g}")
        if a.state_dir and cycle % a.save_every == 0:
            game.save(f"model-{cycle}", cycle, best, lr_scale)
    sync()
    t_cycles = time.time() - t1
    iou, mcov = game.validate(val_img, val_flow, val_gt)
    record["hist"].append((a.cycles, iou, mcov))
    tail = [v for _, v, _ in record["hist"][-8:]]
    log(f"final: best IoU {best:.3f}; last-8 mean {np.mean(tail):.3f}; "
        f"{'CONVERGED (sustained IoU > 0.5)' if np.mean(tail) > 0.5 else 'did not lock on'}")
    record.update(game=game, cycles_run=max(0, a.cycles - start_cycle + 1),
                  seconds={"pretrain": t_pre, "cycles": t_cycles})
    return record


def main(argv=None, environ=None, log=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv, environ)
    resolve_device(args.device)      # no card and no --device=cpu: raise now
    return run(args, log or (lambda line: print(line, flush=True)))


if __name__ == "__main__":
    main()
