"""Recover-net pretraining: flow inpainting of random box occlusions,
counterpart of unsupervised_detection_tpu/train/pretrain.py.

Frame pairs come from a dataset reader (or any iterable of host batches);
the frozen PWC net computes their flow, which is resized to the working
resolution as the game does (train/objective.py), and the recover net
learns to reconstruct that flow inside one random box per sample from the
flow outside it and the image: the per-pixel Charbonnier loss, gradients
clipped per element to +-gradient_clip (no noise branch), `optax.adam`'s
update at a constant rate (train/optim.py::OptaxAdam).

PWC runs without autograd, so a step launches the cost-volume and warp
forward kernels (5 and 4) and no backward kernel.

On a mesh (parallel/mesh.py) each rank takes its rows of the global batch;
the box draws are made for the global batch from the same generator on
every rank, the loss divides by the global batch's pixel count, and the
gradients and the loss are summed over the data group before the clip and
Adam. As in JAX (pretrain.py:48-136 there) the objective is built without
the mesh: every rank computes the whole cost volume.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..data import TrainPipeline, get_reader
from ..data.device_input import DeviceFeeder
from ..device import precision_scope
from ..ops.losses import charbonnier_loss
from ..parallel.mesh import Mesh
from . import checkpoint as ckpt
from .objective import AdversarialObjective
from .optim import OptaxAdam


def sample_box_draws(gen: torch.Generator, batch: int) -> dict:
    """The four (B,) uniform [0, 1) float32 draws of `random_box_masks` from
    a CPU `torch.Generator`, in JAX's order (height, width, y, x)."""
    return {k: torch.rand((batch,), generator=gen) for k in ("h", "w", "y", "x")}


def random_box_masks(draws: dict, height: int, width: int, min_frac: float = 0.15,
                     max_frac: float = 0.45, device=None) -> torch.Tensor:
    """(B, H, W, 1) float32 masks with one box of 1s per sample, from
    `sample_box_draws` (or JAX's draws): box sides of min_frac..max_frac of
    the frame and corners uniform in what is left, with JAX's float32
    arithmetic (pretrain.py:33-46 there) and float32 iotas compared against
    float32 bounds."""
    d = {k: v.to(device=device, dtype=torch.float32) for k, v in draws.items()}
    bh = height * (min_frac + d["h"] * (max_frac - min_frac))
    bw = width * (min_frac + d["w"] * (max_frac - min_frac))
    y0 = d["y"] * (height - bh)
    x0 = d["x"] * (width - bw)
    yy = torch.arange(height, dtype=torch.float32, device=device).view(1, height, 1)
    xx = torch.arange(width, dtype=torch.float32, device=device).view(1, 1, width)

    def col(v):
        return v.view(-1, 1, 1)

    inside = ((yy >= col(y0)) & (yy < col(y0 + bh)) & (xx >= col(x0)) & (xx < col(x0 + bw)))
    return inside.to(torch.float32)[..., None]


def inpainting_loss(recover, image: torch.Tensor, flow: torch.Tensor, mask: torch.Tensor,
                    cbn: float, n_data: int = 1) -> torch.Tensor:
    """Per-pixel Charbonnier loss of the recover net's flow, given the flow
    outside the boxes and the boxes, against the whole flow; over a batch
    that is one of `n_data` equal row blocks of the global batch, this
    block's share of the global loss."""
    pred = recover(image, flow * (1.0 - mask), mask)
    total = charbonnier_loss(flow, pred, torch.ones_like(flow), cbn)
    b, h, w, _ = image.shape
    return total.sum() / (h * w * b * n_data)


class RecoverPretrainer:
    """The frozen PWC net and the recover net (through the game's
    `AdversarialObjective`), the recover net's Adam and the box stream on
    one device and this rank's `mesh` (None: the trivial one); `step` is one
    update of `pretrain_recover`. Initial weights come from `config.seed`."""

    def __init__(self, config: Config, device=None, mesh: Mesh | None = None):
        self.config = config
        self.mesh = mesh if mesh is not None else Mesh()
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(config.seed)
            self.objective = AdversarialObjective(config, device)
        self.device, self.dtype = self.objective.device, self.objective.dtype
        self.pwc, self.recover = self.objective.pwc, self.objective.recover
        self.pwc.requires_grad_(False)
        self.params = list(self.recover.parameters())
        self.opt = OptaxAdam(self.params, config.learning_rate, config.beta1,
                             config.adam_epsilon)
        self.rng = torch.Generator().manual_seed(config.seed)

    def grads(self, image: torch.Tensor, flow: torch.Tensor, mask: torch.Tensor):
        """(loss, gradients clipped per element to +-gradient_clip) of one
        inpainting batch at the working resolution; on a mesh, this rank's
        rows, and the global batch's loss and gradients."""
        cfg, mesh = self.config, self.mesh
        with precision_scope(self.dtype):
            loss = inpainting_loss(self.recover, image, flow, mask, cfg.cbn, mesh.n_data)
            grads = torch.autograd.grad(loss, self.params)
        *grads, loss = mesh.sum_data(list(grads) + [loss])
        return loss.detach(), [g.clamp(-cfg.gradient_clip, cfg.gradient_clip) for g in grads]

    def step(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """One update from reader-resolution frames (this rank's rows);
        returns the loss before it."""
        cfg, mesh = self.config, self.mesh
        with precision_scope(self.dtype):
            flow = self.objective.compute_flow(img1, img2)
            image, flow = self.objective.resize_to_working(img1, flow)
        draws = sample_box_draws(self.rng, image.shape[0] * mesh.n_data)
        mask = random_box_masks(mesh.shard(draws), cfg.img_height, cfg.img_width,
                                device=self.device)
        loss, grads = self.grads(image, flow, mask)
        self.opt.step(grads)
        return loss


def _train_batches(config: Config, mesh: Mesh):
    reader = get_reader(config.dataset, config.root_dir,
                        max_temporal_len=config.max_temporal_len,
                        min_temporal_len=config.min_temporal_len,
                        num_threads=config.num_threads)
    raw_hw = (reader.raw_height, reader.raw_width) if reader.raw_height is not None else None
    return TrainPipeline(
        reader.dataset(config.train_partition), config.batch_size, config.min_temporal_len,
        config.max_temporal_len, reader_hw=(config.reader_height, config.reader_width),
        raw_hw=raw_hw, num_threads=config.num_threads, seed=config.seed,
        rows=mesh.batch_rows(config.batch_size))


def pretrain_recover(config: Config, steps: int, verbose: bool = True, save_every: int = 1000,
                     device=None, batches=None, mesh: Mesh | None = None):
    """Train the recover net on box-occlusion inpainting on `device` (None =
    the card; raises without one); returns the recover net.

    PWC weights come from `--flow_ckpt` (a scope save of `pretrain_flow`, a
    full training save of the port or a TF1 bundle's prefix); without one `--allow_random_flow`
    must be set, as for training. Frame pairs come from the config's
    dataset through `TrainPipeline`, or from `batches`, an iterable of host
    batches in the pipeline's format. With config.checkpoint_dir set, scope
    saves `recover-<step>` every `save_every` steps and `recover-final` are
    written, which `--recover_ckpt` reads. On a `mesh` config.batch_size is
    the global batch, `batches` are global batches, and global rank 0
    alone restores (and broadcasts), prints and saves."""
    if not config.flow_ckpt and not config.allow_random_flow:
        # as train/driver.py: inpainting targets from a random flow net are garbage
        raise SystemExit(
            "pretrain_recover needs --flow_ckpt (a pretrain_flow scope save or a "
            "training save). Pass --allow_random_flow to pretrain against a "
            "randomly initialized flow net (tests/synthetic runs only).")
    mesh = mesh if mesh is not None else Mesh()
    verbose = verbose and mesh.is_main
    save = bool(config.checkpoint_dir) and mesh.is_main
    trainer = RecoverPretrainer(config, device, mesh)
    if config.flow_ckpt and mesh.is_main:
        ckpt.restore_params_scope(config.flow_ckpt, trainer.pwc, "pwc_params")
    mesh.broadcast(list(trainer.pwc.state_dict().values()))
    feeder = DeviceFeeder((config.reader_height, config.reader_width), trainer.device, mesh)
    it = iter(batches if batches is not None else _train_batches(config, mesh))
    try:
        for step in range(1, steps + 1):
            img1, img2 = feeder.images(next(it))
            loss = trainer.step(img1, img2)
            if verbose and step % 20 == 0:
                print("step %d: inpainting loss %.5f" % (step, float(loss)))
            if save and step % save_every == 0:
                ckpt.save_scope(config.checkpoint_dir, f"recover-{step}", trainer.recover,
                                "rec_params")
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    if save:
        ckpt.save_scope(config.checkpoint_dir, "recover-final", trainer.recover, "rec_params")
    return trainer.recover
