"""Adversarial learner: train state, the two players' steps, validation.

Counterpart of unsupervised_detection_tpu/train/learner.py (reference
models/adversarial_learner.py:206-448), on one device or on one rank of a
data- and model-parallel mesh (parallel/mesh.py):

  * `TrainState` holds the step, the torch.Generator of the augmentation
    and gradient-noise draws, the three nets (the objective's modules,
    updated in place) and the two TF1 Adam states, whose counts give the
    shared bias-correction step (train/optim.py);
  * each step augments the batch on the device, runs the forward with
    PWC frozen, and takes gradients of its own loss for its own net only
    (`torch.autograd.grad`); the generator's loss still back-propagates
    through the recover net to the mask;
  * per-element clipping to +-clip and the generator's vanishing-gradient
    noise (loss_utils.py:7-32); `select_step` is the reference's 1:3
    alternation;
  * `summary_images` gives the driver's TensorBoard images.

On a mesh each step takes this rank's rows of the global batch. The
augmentation and the noise are drawn from `state.rng` for the global
batch on every rank, and the rank takes its rows, so every generator
advances alike. Each rank's loss is its share of the global loss
(train/objective.py); one flat all_reduce over the data group sums the
gradients and the logged losses before the clip, the noise test and Adam,
so the parameters stay equal on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..device import precision_scope
from ..data.device_input import DeviceFeeder
from ..models import GeneratorNet, PWCNet, RecoverNet
from ..ops.augment import augment_pair, sample_augment
from ..ops.flow import flow_to_image_summary
from ..ops.metrics import disambiguate_forward_background
from ..ops.resize import central_crop_resize, resize_bilinear
from ..parallel.mesh import Mesh
from ..utils.profiling import span
from .objective import AdversarialObjective
from .optim import AdamState, adam_apply, adam_init


@dataclasses.dataclass
class TrainState:
    """The nets here ARE the learner's `objective` modules, not copies: the
    steps update their parameters in place and return the same state with
    its step, Adam states and rng advanced. Two `init_state()` calls give
    states that share these weights but not their Adam moments."""

    step: int                   # completed alternation cycles (global_step)
    rng: torch.Generator         # on the CPU: the same draws on every device
    generator: GeneratorNet
    recover: RecoverNet
    pwc: PWCNet
    gen_opt: AdamState
    rec_opt: AdamState

    @property
    def shared_adam_t(self) -> int:
        """The shared Adam step of the NEXT apply of either net."""
        return self.gen_opt.count + self.rec_opt.count + 1


def _clip_or_noise(rng: torch.Generator, grads, clip_value: float,
                   noise_threshold: float, can_change: bool) -> list[torch.Tensor]:
    """Per-element clip to +-clip_value. With `can_change` (the generator),
    when the mean over tensors of mean|g| of the unclipped gradients is
    below `noise_threshold` (the all-mask / no-mask minimum), every
    gradient is replaced by |U(-clip, clip)| noise drawn from `rng`
    (loss_utils.py:7-26)."""
    with span("ud.train.clip"):
        clipped = [g.clamp(-clip_value, clip_value) for g in grads]
    if not can_change:
        return clipped
    grad_avg = torch.stack([g.abs().mean() for g in grads]).mean()
    with span("ud.train.noise_test"):
        vanishing = bool(grad_avg < noise_threshold)
    if not vanishing:
        return clipped
    return [(torch.rand(g.shape, generator=rng) * (2.0 * clip_value) - clip_value)
            .abs().to(device=g.device, dtype=g.dtype) for g in grads]


def apply_update(state: TrainState, params: dict, grads, losses: dict, opt_name: str,
                 can_change: bool, config: Config, adam_hparams: tuple,
                 mesh: Mesh | None = None, lr_scale: float = 1.0):
    """The part of a player's step after its loss, shared by the learner
    and the recipe's game (recipe/game.py): the gradients of `params` (this
    net's, by name) and the logged `losses` summed over the data group in
    one all_reduce, the clip or the generator's noise (`can_change`), then
    TF1 Adam on `state.<opt_name>` at the shared step (or the net's own,
    without `adam_shared_step`) and the rate `adam_hparams[0] * lr_scale`
    in float32 (the game's post-lock lever). Returns (state, the global
    batch's losses detached, the applied gradients)."""
    mesh = mesh if mesh is not None else Mesh()
    keys = list(losses)
    with span("ud.train.all_reduce"):
        summed = mesh.sum_data(list(grads) + [losses[k] for k in keys])
    grads, losses = summed[:len(grads)], dict(zip(keys, summed[len(grads):]))
    grads = _clip_or_noise(state.rng, grads, config.gradient_clip,
                           config.grad_noise_threshold, can_change)
    opt = getattr(state, opt_name)
    t = state.shared_adam_t if config.adam_shared_step else opt.count + 1
    lr, *rest = adam_hparams
    lr = float(np.float32(lr) * np.float32(lr_scale))
    setattr(state, opt_name, adam_apply(dict(zip(params, grads)), opt, params, t, lr, *rest))
    return state, {k: v.detach() for k, v in losses.items()}, grads


class AdversarialLearner:
    """The objective's three nets on one device, the two players' steps and
    validation, on this rank's `mesh` (None: the trivial one). `device=None`
    means the first CUDA device and raises without one. The nets' initial
    weights come from `config.seed`, the same on every rank."""

    def __init__(self, config: Config, device=None, mesh: Mesh | None = None):
        self.config = config
        self.mesh = mesh if mesh is not None else Mesh()
        # the nets are initialized on the CPU, from the CPU generator
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(config.seed)
            self.objective = AdversarialObjective(config, device, self.mesh)
        self.device = self.objective.device
        self.dtype = self.objective.dtype
        for net in (self.objective.generator, self.objective.recover, self.objective.pwc):
            net.requires_grad_(False)
        # (lr, b1, b2, eps) of train/optim.adam_apply (adversarial_learner.py:216-233)
        self.adam_hparams = (config.learning_rate, config.beta1, 0.999, config.adam_epsilon)
        self.feeder = DeviceFeeder((config.reader_height, config.reader_width), self.device,
                                   self.mesh)

    def init_state(self) -> TrainState:
        obj = self.objective
        return TrainState(
            step=0, rng=torch.Generator().manual_seed(self.config.seed),
            generator=obj.generator, recover=obj.recover, pwc=obj.pwc,
            gen_opt=adam_init(dict(obj.generator.named_parameters())),
            rec_opt=adam_init(dict(obj.recover.named_parameters())))

    def _step(self, state: TrainState, img1, img2, draws, net, loss_key: str,
              opt_name: str, can_change: bool):
        cfg, mesh = self.config, self.mesh
        params = dict(net.named_parameters())
        with precision_scope(self.dtype):
            with span("ud.train.augment"):
                if draws is None:
                    b, h, w, _ = img1.shape
                    draws = sample_augment(state.rng, b * mesh.n_data, h, w, cfg.train_crop)
                img1, img2 = augment_pair(mesh.shard(draws), img1, img2)
            net.requires_grad_(True)
            try:
                out = self.objective.forward(img1, img2)
                with span("ud.train.backward"):
                    grads = torch.autograd.grad(out.losses[loss_key], list(params.values()))
            finally:
                net.requires_grad_(False)
        return apply_update(state, params, grads, out.losses, opt_name, can_change, cfg,
                            self.adam_hparams, mesh)

    def generator_step(self, state: TrainState, img1: torch.Tensor, img2: torch.Tensor,
                       draws: dict | None = None):
        """One generator update from a reader-resolution batch (this rank's
        rows of it); returns (state, losses before the update, the applied
        gradients), those of the global batch. `draws` are the global
        batch's augmentation draws (`ops.augment.sample_augment`); None
        draws them from `state.rng`."""
        return self._step(state, img1, img2, draws, state.generator, "generator",
                          "gen_opt", True)

    def recover_step(self, state: TrainState, img1: torch.Tensor, img2: torch.Tensor,
                     draws: dict | None = None):
        """One recover update; as `generator_step`, without the noise."""
        return self._step(state, img1, img2, draws, state.recover, "recover",
                          "rec_opt", False)

    @staticmethod
    def incr_step(state: TrainState) -> TrainState:
        state.step += 1
        return state

    @torch.inference_mode()
    def val_step(self, state: TrainState, img1: torch.Tensor, img2: torch.Tensor,
                 gt_masks: torch.Tensor) -> torch.Tensor:
        """Sum of the per-sample validation IoU of one batch, after the
        test-time central crop; on a mesh, of the global batch (summed over
        the data group)."""
        cfg = self.config
        with precision_scope(self.dtype):
            if cfg.test_crop != 1.0:
                img1 = central_crop_resize(img1, cfg.test_crop)
                img2 = central_crop_resize(img2, cfg.test_crop)
                gt_masks = central_crop_resize(gt_masks, cfg.test_crop)
            return self.mesh.sum_data([self.objective.validation_iou(img1, img2, gt_masks)
                                       .sum()])[0]

    @torch.no_grad()
    def summary_images(self, state: TrainState, img1: torch.Tensor,
                       img2: torch.Tensor) -> dict[str, torch.Tensor]:
        """The image summaries of the batch's first pair (the reference's
        collect_summaries, adversarial_learner.py:260-281), (1, h, w, 3)
        float32 in [-0.5, 0.5] on the device: the inputs, the PWC flow
        colorized and masked by the foreground, and the recover net's flow
        and its complement colorized. On a mesh the first pair is on data
        index 0, and every rank of its model group must call this."""
        cfg = self.config
        img1, img2 = img1[:1], img2[:1]
        with precision_scope(self.dtype):
            out = self.objective.forward(img1, img2)
            next_image = resize_bilinear(img2, (cfg.img_height, cfg.img_width))
        pwc_viz = flow_to_image_summary(out.flow.float())
        fg = disambiguate_forward_background(out.mask.float())
        return {"input_image": out.image.float(), "next_image": next_image.float(),
                "masked_flow": pwc_viz * (1.0 - fg), "PWC_Flow": pwc_viz,
                "Rec_flow": flow_to_image_summary(out.pred_flow.float()),
                "Rec_flow_compl": flow_to_image_summary(out.pred_flow_compl.float())}

    def select_step(self, sub_step: int):
        """The reference alternation (adversarial_learner.py:386-389):
        sub-steps with (step % (iters_rec + iters_gen)) < iters_rec train the
        recover net, the rest the generator; `sub_step` starts at 1."""
        cfg = self.config
        if (sub_step % (cfg.iters_rec + cfg.iters_gen)) < cfg.iters_rec:
            return self.recover_step
        return self.generator_step
