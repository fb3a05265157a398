"""The contextual-information-separation objective, counterpart of
unsupervised_detection_tpu/train/objective.py (reference
models/adversarial_learner.py:72-204):

  flow   = PWC(I1, I2) at reader resolution, resized to the working
           resolution with the vectors NOT rescaled (reference
           adversarial_learner.py:87-97) and divided by flow_normalizer;
  M      = G(I1, standardize(flow));         Mc = 1 - M
  F_hat  = R(I1, flow*(1-M), M)
  F_hatc = R(I1, flow*(1-Mc), Mc)
  F_img  = R(I1, 0, 1)                       (image-only prior)

  recover_loss   = (rho(F_hat,F,M) + rho(F_hatc,F,Mc) + rho(F_img,F,1)) / BHW
  generator_loss = mean(1 - rho(F_hat,F,M)/(rho(F_img,F,M)+eps))
                 + mean(1 - rho(F_hatc,F,Mc)/(rho(F_img,F,Mc)+eps))

with rho the per-sample masked Charbonnier sum (ops/losses.py). PWC is
frozen: its forward runs without autograd.

On a mesh (parallel/mesh.py) the batch is this rank's rows of the global
batch, and each loss is this rank's share of the global batch's: the means
are divided by n_data, the recover loss's pixel count is the global one,
and the sample-0 entries (reconstruction_loss, denominator_red_rate, ...)
are zero except on data index 0. Summed over the data group they are the
losses of one process on the global batch. A model axis wider than one
splits PWC's cost volume (models/pwcnet.py), as JAX's objective.py:55-77
shards its offsets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..device import compute_dtype, resolve_device
from ..models import GeneratorNet, PWCNet, RecoverNet
from ..ops.flow import standardize_flow
from ..ops.losses import charbonnier_loss
from ..ops.metrics import compute_all_iou
from ..ops.resize import resize_bilinear, resize_bilinear_composed, resize_nearest
from ..parallel.mesh import Mesh
from ..utils.profiling import span


class ForwardOutputs(NamedTuple):
    losses: dict[str, torch.Tensor]
    image: torch.Tensor
    flow: torch.Tensor
    mask: torch.Tensor
    flow_masked: torch.Tensor
    pred_flow: torch.Tensor
    pred_flow_compl: torch.Tensor


class AdversarialObjective:
    """Holds the generator, the recover net and the frozen PWC net for one
    config on one device, and this rank's `mesh` (None: the trivial one).
    Weights come from `load_state_dicts` (see convert.py) or from a training
    save (train/checkpoint.py)."""

    def __init__(self, config: Config, device=None, mesh: Mesh | None = None):
        self.config = config
        self.mesh = mesh if mesh is not None else Mesh()
        self.device = resolve_device(device)
        self.dtype = compute_dtype(config.compute_dtype)
        self.generator = GeneratorNet(dtype=self.dtype).to(self.device).eval()
        self.recover = RecoverNet(dtype=self.dtype).to(self.device).eval()
        self.pwc = PWCNet(
            pyr_lvls=config.pwc_pyr_lvls,
            flow_pred_lvl=config.pwc_flow_pred_lvl,
            search_range=config.pwc_search_range,
            dtype=self.dtype,
            mesh=self.mesh,
        ).to(self.device).eval()

    def load_state_dicts(self, gen_state: dict, pwc_state: dict) -> None:
        self.generator.load_state_dict(gen_state)
        self.pwc.load_state_dict(pwc_state)

    @property
    def fuse_flow_resize(self) -> bool:
        return self.dtype == torch.bfloat16

    def compute_flow(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """Frozen PWC flow. In the fused-resize (bfloat16) mode it stays at
        quarter resolution for `resize_to_working`. With
        flow_resolution_divisor > 1 the flow net runs on downscaled frames."""
        d = self.config.flow_resolution_divisor
        if d > 1:
            size = (self.config.reader_height // d, self.config.reader_width // d)
            mult = 2**self.pwc.pyr_lvls
            if size[0] % mult or size[1] % mult:
                raise ValueError(f"flow resolution {size} not divisible by {mult}")
            img1 = resize_bilinear(img1, size)
            img2 = resize_bilinear(img2, size)
        with torch.no_grad():
            return self.pwc(img1, img2, upsample_output=not self.fuse_flow_resize)

    def resize_to_working(self, img1: torch.Tensor, flow: torch.Tensor):
        """Image and flow at the working resolution; flow vectors keep
        reader-resolution pixel units and are divided by flow_normalizer."""
        cfg = self.config
        d = cfg.flow_resolution_divisor
        size = (cfg.img_height, cfg.img_width)
        with span("ud.model.working_resize"):
            image = resize_bilinear(img1, size)
            if self.fuse_flow_resize:
                # quarter-res flow -> working res in one composed resize; the x4
                # magnitude scale and the divisor commute with the resize
                mid = (cfg.reader_height // d, cfg.reader_width // d)
                scale = 2**self.pwc.flow_pred_lvl * d
                flow = resize_bilinear_composed(flow, mid, size) * (scale / cfg.flow_normalizer)
            else:
                if d > 1:
                    flow = flow * d
                flow = resize_bilinear(flow, size) / cfg.flow_normalizer
        return image, flow

    def generate_mask(self, image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        with span("ud.model.generator"):
            return self.generator(image, standardize_flow(flow))

    # --- losses -----------------------------------------------------------
    def _share(self, mean: torch.Tensor) -> torch.Tensor:
        """This rank's share of a mean over the global batch."""
        n = self.mesh.n_data
        return mean if n == 1 else mean / n

    def _first(self, per_sample: torch.Tensor) -> torch.Tensor:
        """Sample 0 of the global batch on data index 0, zero elsewhere."""
        first = per_sample[0]
        return first if self.mesh.data_index == 0 else torch.zeros_like(first)

    def losses_from_flow(self, image: torch.Tensor, flow: torch.Tensor) -> ForwardOutputs:
        """All two-player losses from the working-resolution image and flow:
        the three recover calls share the recover net's weights. On a mesh,
        this rank's shares (module docstring)."""
        cfg = self.config
        mask = self.generate_mask(image, flow)
        mask_c = 1.0 - mask
        flow_masked = flow * (1.0 - mask)
        flow_masked_c = flow * (1.0 - mask_c)

        pred = self.recover(image, flow_masked, mask)
        pred_c = self.recover(image, flow_masked_c, mask_c)
        pred_img = self.recover(image, torch.zeros_like(flow), torch.ones_like(mask))

        cbn = cfg.cbn
        rec_loss = charbonnier_loss(flow, pred, mask, cbn)              # (B,)
        rec_compl_loss = charbonnier_loss(flow, pred_c, mask_c, cbn)    # (B,)
        image_prior = charbonnier_loss(flow, pred_img, torch.ones_like(flow), cbn)
        num_pixels = cfg.img_width * cfg.img_height * image.shape[0] * self.mesh.n_data
        recover_loss = (rec_loss.sum() + rec_compl_loss.sum() + image_prior.sum()) / num_pixels

        den = charbonnier_loss(flow, pred_img, mask, cbn) + cfg.epsilon
        red_rate_object = self._share((1.0 - rec_loss / den).mean())
        den_c = charbonnier_loss(flow, pred_img, mask_c, cbn) + cfg.epsilon
        red_rate_compl = self._share((1.0 - rec_compl_loss / den_c).mean())

        losses = {
            "generator": red_rate_object + red_rate_compl,
            "recover": recover_loss,
            "red_rate": red_rate_object,
            "red_rate_compl": red_rate_compl,
            "reconstruction_loss": self._first(rec_loss),
            "reconstruction_compl_loss": self._first(rec_compl_loss),
            "denominator_red_rate": self._first(den),
            "denominator_red_rate_compl": self._first(den_c),
        }
        return ForwardOutputs(
            losses=losses, image=image, flow=flow, mask=mask, flow_masked=flow_masked,
            pred_flow=pred * mask + flow * (1.0 - mask),
            pred_flow_compl=pred * mask_c + flow * (1.0 - mask_c))

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> ForwardOutputs:
        """Train/val forward from reader-resolution frames."""
        flow = self.compute_flow(img1, img2)
        image, flow = self.resize_to_working(img1, flow)
        return self.losses_from_flow(image, flow)

    # --- validation -------------------------------------------------------
    def validation_iou(self, img1: torch.Tensor, img2: torch.Tensor,
                       gt_masks: torch.Tensor) -> torch.Tensor:
        """(B,) IoU of the disambiguated masks against the GT resized
        (nearest) to the working resolution (adversarial_learner.py:133-137)."""
        cfg = self.config
        flow = self.compute_flow(img1, img2)
        image, flow = self.resize_to_working(img1, flow)
        gt = resize_nearest(gt_masks, (cfg.img_height, cfg.img_width))
        mask = self.generate_mask(image, flow)
        return compute_all_iou(pred_masks=mask, gt_masks=gt)
