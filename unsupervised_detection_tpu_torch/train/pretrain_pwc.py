"""PWC flow-network pretraining on synthetic warped scenes, counterpart of
unsupervised_detection_tpu/train/pretrain_pwc.py.

FlyingChairs-style supervised training with no external data: a textured
frame I1, a smooth flow field F (affine plus a low-frequency sinusoid,
channels (dy, dx)), and I2 = warp(I1, -F), so that I2(p) = I1(p + F(p)) and
the flow PWC should report for (I1, I2) is F. The loss is the end-point
error of the full-resolution output plus 0.1 x the EPE of each pyramid
level against resize(F)/20 (resize(F)/2**flow_pred_lvl at the output
level), optionally reweighted towards objects and their boundary band.

The gradient runs through the whole flow net, so through the cost volume
and the warp: on the card their backward kernels (ops/cost_volume.py,
ops/warp.py), 5 and 4 launches per step, beside the forward kernels' 5 and
4 and the synthesizer's one warp. The optimizer is `optax.adam`'s update
(train/optim.py::OptaxAdam), with an optional warmup-cosine schedule.

Divergence from JAX: at an exactly zero error the norm's gradient is NaN in
JAX and 0 here.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..device import compute_dtype, precision_scope, resolve_device
from ..models import PWCNet
from ..ops.resize import resize_bilinear
from ..ops.warp import dense_image_warp
from . import checkpoint as ckpt
from .optim import OptaxAdam, warmup_cosine_lr

LR_SCHEDULES = ("constant", "cosine")
BOUNDARY_MODES = ("final", "all")


def _upsample_linear(base: np.ndarray, height: int, width: int, device) -> torch.Tensor:
    """`jax.image.resize(base, (B, height, width, 3), "linear")` for an
    upsample: half-pixel centres, weights past the edge dropped and the rest
    renormalised, which is bilinear with align_corners=False."""
    x = torch.from_numpy(base).to(device).permute(0, 3, 1, 2)
    up = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)


def synthetic_flow_batch(rng: np.random.RandomState, batch: int, height: int, width: int,
                         max_mag: float = 12.0, device=None):
    """(img1, img2, flow) float32 tensors on `device` (None = the card), with
    I2(p) = I1(p + F(p)) and smooth random F, from the same RandomState
    calls in the same order as the JAX package's (so one seed gives one
    batch): textures in [-0.5, 0.5] upsampled x8 and x2, F an affine field
    plus a sinusoid, clipped to +-max_mag pixels, channels (dy, dx).

    F(y, x) = a + l0*yn + l1*xn + amp*sin(2pi*fy*yn + p0)*cos(2pi*fx*xn + p1)
    separates into per-row and per-column terms: those are computed on the
    host in float64, as numpy evaluates the JAX package's expression, and
    combined on the device in float64 with the same operations, then cast
    to float32. img2 is one launch of the port's warp (C=3)."""
    device = resolve_device(device)

    def texture(scale, amp):
        base = rng.rand(batch, height // scale, width // scale, 3).astype(np.float32)
        return amp * (_upsample_linear(base, height, width, device) - 0.5)

    img1 = torch.clamp(texture(8, 0.7) + texture(2, 0.3), -0.5, 0.5)

    yn = (np.arange(height, dtype=np.float32) - height / 2) / height   # float32, as np.mgrid
    xn = (np.arange(width, dtype=np.float32) - width / 2) / width
    yn64, xn64 = yn.astype(np.float64), xn.astype(np.float64)
    rows = np.empty((batch, 2, height), np.float64)     # a + l0*yn
    sines = np.empty((batch, 2, height), np.float64)    # amp*sin(...)
    cosines = np.empty((batch, 2, width), np.float64)
    l1 = np.empty((batch, 2), np.float64)
    for b in range(batch):
        for ch in range(2):
            a = rng.uniform(-0.5, 0.5) * max_mag
            lin = rng.uniform(-0.5, 0.5, 2) * max_mag
            amp = rng.uniform(-0.3, 0.3) * max_mag
            fy, fx = rng.uniform(1.0, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            rows[b, ch] = a + lin[0] * yn64
            l1[b, ch] = lin[1]
            sines[b, ch] = amp * np.sin(2 * np.pi * fy * yn64 + ph[0])
            cosines[b, ch] = np.cos(2 * np.pi * fx * xn64 + ph[1])

    def dev(a):
        return torch.from_numpy(a).to(device)

    field = ((dev(rows)[..., :, None] + dev(l1)[..., None, None] * dev(xn64))
             + dev(sines)[..., :, None] * dev(cosines)[..., None, :])     # (B, 2, H, W)
    flow = torch.clamp(field.permute(0, 2, 3, 1).to(torch.float32), -max_mag, max_mag)
    with torch.no_grad():
        img2 = dense_image_warp(img1, (-flow).contiguous())
    return img1, img2, flow.contiguous()


def boundary_band(mask: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """dilate(m) - erode(m) of a (B, H, W, 1) {0, 1} mask over a
    (2r+1)^2 window, -inf padded as `reduce_window` SAME: 1 where both
    classes occur within `radius` (Chebyshev)."""
    x = mask.permute(0, 3, 1, 2)
    k = 2 * radius + 1
    dil = F.max_pool2d(x, k, stride=1, padding=radius)
    ero = -F.max_pool2d(-x, k, stride=1, padding=radius)
    return (dil - ero).permute(0, 2, 3, 1)


def multiscale_epe(flow_pred: torch.Tensor, flow_pyr, flow_gt: torch.Tensor,
                   flow_pred_lvl: int = 2, aux_weight: float = 0.1,
                   weight: Optional[torch.Tensor] = None,
                   weight_aux: Optional[torch.Tensor] = None):
    """(loss, epe): final-resolution EPE plus `aux_weight` x the EPE of each
    pyramid level (coarse to fine) against resize(F)/20, and
    resize(F)/2**flow_pred_lvl at the output level (TF1-legacy resize).
    `weight` ((B, H, W, 1)) reweights pixels in every level's mean (the sum
    of weights, at least 1e-6, normalises); `weight_aux` replaces it on the
    pyramid levels. `epe` is the unweighted final EPE."""
    err = torch.linalg.vector_norm(flow_pred - flow_gt, dim=-1)
    epe = err.mean()

    def wmean(e, w):
        if w is None:
            return e.mean()
        w = w[..., 0]
        return (e * w).sum() / torch.clamp(w.sum(), min=1e-6)

    loss = wmean(err, weight)
    aux = 0.0
    w_base = weight if weight_aux is None else weight_aux
    for i, flow_l in enumerate(flow_pyr):
        size = (flow_l.shape[1], flow_l.shape[2])
        scale = 2.0**flow_pred_lvl if i == len(flow_pyr) - 1 else 20.0
        target = resize_bilinear(flow_gt, size) / scale
        w_l = None if w_base is None else resize_bilinear(w_base, size)
        aux = aux + wmean(torch.linalg.vector_norm(flow_l.float() - target, dim=-1), w_l)
    return loss + aux_weight * aux, epe


def pwc_loss(net: PWCNet, img1, img2, flow_gt, obj_mask=None, object_weight: float = 0.0,
             boundary_weight: float = 0.0, boundary_mode: str = "final"):
    """(loss, epe, regions) of one batch: JAX's `loss_fn` (pretrain_pwc.py
    :204-232 there). With an object mask, pixels weigh 1 + object_weight *
    mask, the boundary band adds boundary_weight in the final level only
    ("final") or in every level ("all"), and `regions` holds the EPE inside
    the objects, in the background and, with a band, in the band
    (detached); else it is ()."""
    flow_pred, flow_pyr = net(img1, img2, return_pyramid=True)
    weight = weight_aux = band = None
    if obj_mask is not None:
        weight = 1.0 + object_weight * obj_mask
        if boundary_weight:
            band = boundary_band(obj_mask)
            if boundary_mode == "final":
                weight_aux = weight
            weight = weight + boundary_weight * band
    loss, epe = multiscale_epe(flow_pred, flow_pyr, flow_gt, net.flow_pred_lvl,
                               weight=weight, weight_aux=weight_aux)
    regions = ()
    if obj_mask is not None:
        err = torch.linalg.vector_norm(flow_pred.detach() - flow_gt, dim=-1, keepdim=True)

        def rmean(m):
            return (err * m).sum() / torch.clamp(m.sum(), min=1.0)

        regions = (rmean(obj_mask), rmean(1 - obj_mask))
        if band is not None:
            regions = regions + (rmean(band),)
    return loss, epe, regions


class PWCPretrainer:
    """The PWC net, its Adam and its schedule on one device; `step` is one
    update of `pretrain_pwc`. The net's initial weights come from
    `config.seed` (flax's initialisers' distributions, not JAX's draws), or
    from `params`, a PWCNet state dict."""

    def __init__(self, config: Config, steps: int, learning_rate: Optional[float] = None,
                 params: Optional[dict] = None, lr_schedule: str = "constant",
                 object_weight: float = 0.0, boundary_weight: float = 0.0,
                 boundary_mode: str = "final", device=None):
        if boundary_mode not in BOUNDARY_MODES:
            raise ValueError(f"Unknown boundary_mode: {boundary_mode!r}")
        if lr_schedule not in LR_SCHEDULES:
            raise ValueError(f"Unknown lr_schedule: {lr_schedule!r}")
        self.device = resolve_device(device)
        self.dtype = compute_dtype(config.compute_dtype)
        lr = learning_rate if learning_rate is not None else config.learning_rate
        if lr_schedule == "cosine":
            warmup_cosine_lr(0, lr, steps)          # refuses too few steps now
            self.lr_at = functools.partial(warmup_cosine_lr, lr=lr, steps=steps)
        else:
            self.lr_at = lambda count: lr
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.seed)
            net = PWCNet(pyr_lvls=config.pwc_pyr_lvls, flow_pred_lvl=config.pwc_flow_pred_lvl,
                         search_range=config.pwc_search_range, dtype=self.dtype)
        if params is not None:
            net.load_state_dict(params)
        self.net = net.to(self.device)
        self.params = list(self.net.parameters())
        self.opt = OptaxAdam(self.params, lr, config.beta1, config.adam_epsilon)
        self.loss_kw = dict(object_weight=object_weight, boundary_weight=boundary_weight,
                            boundary_mode=boundary_mode)

    def loss_and_grads(self, img1, img2, flow_gt, obj_mask=None):
        """(loss, epe, regions, gradients of the parameters) of one batch,
        without an update."""
        with precision_scope(self.dtype):
            loss, epe, regions = pwc_loss(self.net, img1, img2, flow_gt, obj_mask,
                                          **self.loss_kw)
            grads = torch.autograd.grad(loss, self.params)
        return loss.detach(), epe.detach(), regions, grads

    def step(self, img1, img2, flow_gt, obj_mask=None):
        """One Adam update from a batch; returns (loss, epe, regions)
        before it, as tensors on the device."""
        loss, epe, regions, grads = self.loss_and_grads(img1, img2, flow_gt, obj_mask)
        self.opt.step(grads, self.lr_at(self.opt.count))
        return loss, epe, regions


def pretrain_pwc(config: Config, steps: int, verbose: bool = True, batch_fn=None,
                 learning_rate: Optional[float] = None, params: Optional[dict] = None,
                 save_every: int = 1000, lr_schedule: str = "constant",
                 object_weight: float = 0.0, boundary_weight: float = 0.0,
                 boundary_mode: str = "final", device=None):
    """Train the PWC net on synthetic warped scenes on `device` (None = the
    card; raises without one); returns (net, final-step EPE in reader
    pixels).

    `batch_fn(rng, batch, H, W)` replaces the scene generator and returns
    (img1, img2, flow) or (img1, img2, flow, object mask), numpy arrays or
    tensors; with a mask the loss upweights objects and their boundary band
    (`pwc_loss`) and the progress line reports EPE by region. `params` is a
    PWCNet state dict to start from. `lr_schedule="cosine"` warms up over
    min(200, steps//10) steps and decays to 5% (`warmup_cosine_lr`). With
    config.checkpoint_dir set, scope saves `pwc-<i>` every `save_every`
    steps and `pwc-final` are written (train/checkpoint.py), which
    `--flow_ckpt` reads."""
    trainer = PWCPretrainer(config, steps, learning_rate, params, lr_schedule, object_weight,
                            boundary_weight, boundary_mode, device)
    dev = trainer.device
    make = batch_fn or functools.partial(synthetic_flow_batch, device=dev)
    h, w = config.reader_height, config.reader_width
    nprng = np.random.RandomState(config.seed)
    epe = float("nan")
    for i in range(1, steps + 1):
        out = [torch.as_tensor(x, dtype=torch.float32, device=dev)
               for x in make(nprng, config.batch_size, h, w)]
        obj_mask = out[3] if len(out) > 3 else None
        loss, epe_t, regions = trainer.step(out[0], out[1], out[2], obj_mask)
        if verbose and (i % 50 == 0 or i == 1):
            extra = ""
            if regions:
                extra = f"  inside {float(regions[0]):.3f}  bg {float(regions[1]):.3f}"
                if len(regions) > 2:
                    extra += f"  band {float(regions[2]):.3f}"
            print(f"pwc-pretrain {i:6d}  loss {float(loss):.4f}  "
                  f"EPE {float(epe_t):.4f} px{extra}", flush=True)
        if config.checkpoint_dir and i % save_every == 0:
            ckpt.save_scope(config.checkpoint_dir, f"pwc-{i}", trainer.net, "pwc_params")
        epe = epe_t
    if config.checkpoint_dir:
        ckpt.save_scope(config.checkpoint_dir, "pwc-final", trainer.net, "pwc_params")
    return trainer.net, float(epe)
