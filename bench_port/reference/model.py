"""The plain reference of the three timed paths, float32 on any device: the
evaluation forward and its metrics, the two-player game's step, and PWC
pretraining's step with its scenes. Frozen from the port's
data/device_input.py, train/objective.py, train/learner.py, train/optim.py,
ops/augment.py, ops/flow.py, ops/losses.py, ops/metrics.py and
train/pretrain_pwc.py, with the plain kernels of reference/kernels.py.
It imports nothing of the program: it is given the benchmark's inputs and
weights and works out everything else (augmentation draws, scenes, resized
flows, optimizer state) again.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .generator import GeneratorNet
from .kernels import dense_image_warp
from .layers import set_quant
from .pwcnet import PWCNet
from .recover import RecoverNet
from .resize import (central_crop_resize, crop_resize_matrices, resize_bilinear,
                     resize_nearest)

CHARBONNIER_EPSILON = 1e-3
BORDER_THRESHOLD, MASK_THRESHOLD = 0.6, 0.1


def nets(cfg: dict, device, quant=None) -> dict:
    """The reference's generator, recover net and PWC-Net for `cfg` on
    `device`, their weights not yet loaded, every convolution rounding
    through `quant`."""
    out = {"generator": GeneratorNet(cfg["cnum"]), "recover": RecoverNet(cfg["recover_f"]),
           "pwc": PWCNet(cfg["pwc_pyr_lvls"], cfg["pwc_flow_pred_lvl"], cfg["pwc_search_range"])}
    return {k: set_quant(v.to(device).eval(), quant) for k, v in out.items()}


# --- evaluation ----------------------------------------------------------------
def preprocess(img_u8: torch.Tensor, gt_u8: torch.Tensor, reader_hw):
    """Raw uint8 frames and 0/255 masks -> reader-resolution float32:
    x / 255 - 0.5 and TF1-legacy bilinear; m / 255 and nearest."""
    img = resize_bilinear(img_u8.float() / 255.0 - 0.5, reader_hw)
    gt = resize_nearest(gt_u8.float() / 255.0, reader_hw)
    return img, gt


def standardize_flow(flow: torch.Tensor) -> torch.Tensor:
    mean = flow.mean(dim=(1, 2), keepdim=True)
    var = ((flow - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    return (flow - mean) / torch.sqrt(var)


def working_inputs(cfg: dict, pwc, img1, img2):
    """(image, flow) at the working resolution: PWC flow at the reader
    resolution, resized with its vectors unscaled, over flow_normalizer."""
    size = (cfg["img_height"], cfg["img_width"])
    flow = pwc(img1, img2)
    return resize_bilinear(img1, size), resize_bilinear(flow, size) / cfg["flow_normalizer"]


def eval_forward(cfg: dict, n: dict, img1_u8, img2_u8, gt_u8):
    """The evaluation path of one batch from raw frames: preprocess, the
    test-time central crop, flow, working inputs, mask. Returns the
    working-resolution (image, flow, gt, mask)."""
    reader = (cfg["reader_height"], cfg["reader_width"])
    img1, gt = preprocess(img1_u8, gt_u8, reader)
    img2, _ = preprocess(img2_u8, gt_u8, reader)
    crop = cfg["test_crop"]
    img1, img2, gt = (central_crop_resize(t, crop) for t in (img1, img2, gt))
    image, flow = working_inputs(cfg, n["pwc"], img1, img2)
    gt = resize_nearest(gt, (cfg["img_height"], cfg["img_width"]))
    mask = n["generator"](image, standardize_flow(flow))
    return image, flow, gt, mask


def foreground(masks: torch.Tensor) -> torch.Tensor:
    """The thresholded mask or its complement, whichever holds less than
    60% of the 2-pixel border (corners counted twice)."""
    binary = (masks > MASK_THRESHOLD).float()
    h, w = masks.shape[1], masks.shape[2]
    border = (binary[:, 0:2].sum(dim=(1, 2, 3)) + binary[:, h - 2:h].sum(dim=(1, 2, 3))
              + binary[:, :, 0:2].sum(dim=(1, 2, 3)) + binary[:, :, w - 2:w].sum(dim=(1, 2, 3)))
    keep = (border / (4.0 * w + 4.0 * h) < BORDER_THRESHOLD).float()[:, None, None, None]
    return keep * binary + (1.0 - keep) * (1.0 - binary)


def iou_mae(masks: torch.Tensor, gt: torch.Tensor):
    """Per-frame IoU and MAE of test_generator.py:19-40 in float64: the
    foreground against any nonzero GT pixel, IoU 1 when both are empty."""
    ann = foreground(masks.float()).double()
    gt = gt.double()
    a, g = ann > 0.5, gt != 0
    inter = (a & g).double().sum(dim=(1, 2, 3))
    union = (a | g).double().sum(dim=(1, 2, 3))
    iou = torch.where(union == 0, torch.ones_like(union), inter / union.clamp(min=1.0))
    return iou, (gt - ann).abs().mean(dim=(1, 2, 3))


# --- the two-player game -------------------------------------------------------
def charbonnier(gt, pred, mask, cbn):
    diff = gt - pred
    return (torch.pow(diff * diff + CHARBONNIER_EPSILON**2, cbn) * mask).sum(dim=(1, 2, 3))


def game_losses(cfg: dict, n: dict, image, flow) -> dict:
    """The 8 losses of the contextual-information-separation objective."""
    cbn = cfg["cbn"]
    mask = n["generator"](image, standardize_flow(flow))
    mask_c = 1.0 - mask
    pred = n["recover"](image, flow * (1.0 - mask), mask)
    pred_c = n["recover"](image, flow * (1.0 - mask_c), mask_c)
    pred_img = n["recover"](image, torch.zeros_like(flow), torch.ones_like(mask))
    rec = charbonnier(flow, pred, mask, cbn)
    rec_c = charbonnier(flow, pred_c, mask_c, cbn)
    prior = charbonnier(flow, pred_img, torch.ones_like(flow), cbn)
    pixels = cfg["img_width"] * cfg["img_height"] * image.shape[0]
    den = charbonnier(flow, pred_img, mask, cbn) + cfg["epsilon"]
    den_c = charbonnier(flow, pred_img, mask_c, cbn) + cfg["epsilon"]
    red = (1.0 - rec / den).mean()
    red_c = (1.0 - rec_c / den_c).mean()
    return {"generator": red + red_c, "recover": (rec.sum() + rec_c.sum() + prior.sum()) / pixels,
            "red_rate": red, "red_rate_compl": red_c, "reconstruction_loss": rec[0],
            "reconstruction_compl_loss": rec_c[0], "denominator_red_rate": den[0],
            "denominator_red_rate_compl": den_c[0]}


def sample_augment(gen: torch.Generator, b: int, h: int, w: int, min_crop: float) -> dict:
    """One step's augmentation draws, in the learner's order: flip case,
    then (p, y0, x0) from one (3, B) uniform draw."""
    case = torch.randint(0, 4, (b,), generator=gen, device=gen.device)
    u = torch.rand((3, b), generator=gen, device=gen.device)
    p = min_crop + u[0] * (1.0 - min_crop)
    return {"case": case, "p": p, "y0": u[1] * (h - h * p), "x0": u[2] * (w - w * p)}


def augment_pair(d: dict, img1, img2):
    """The same flip (identity, rot180, left-right, top-down) of both
    frames, then the same crop of fraction p at (y0, x0) resized back."""
    d = {k: v.to(img1.device) for k, v in d.items()}
    flip_lr = ((d["case"] == 1) | (d["case"] == 2))[:, None, None, None]
    flip_td = ((d["case"] == 1) | (d["case"] == 3))[:, None, None, None]
    _, h, w, _ = img1.shape
    p, y0, x0 = d["p"], d["y0"], d["x0"]
    wh = crop_resize_matrices(h, h, p, y0, clamp_lo=y0, clamp_hi=y0 + h * p - 1.0)
    ww = crop_resize_matrices(w, w, p, x0, clamp_lo=x0, clamp_hi=x0 + w * p - 1.0)

    def apply(img):
        img = torch.where(flip_lr, img.flip(2), img)
        img = torch.where(flip_td, img.flip(1), img)
        y = torch.einsum("boh,bhwc->bowc", wh, img)
        return torch.einsum("bpw,bowc->bopc", ww, y)

    return apply(img1), apply(img2)


def clip_or_noise(gen, grads, clip, threshold, can_change):
    """Per-element clip; for the generator, |U(-clip, clip)| noise in place
    of every gradient when the mean of mean|g| is below `threshold`."""
    clipped = [g.clamp(-clip, clip) for g in grads]
    if not can_change or not bool(torch.stack([g.abs().mean() for g in grads]).mean() < threshold):
        return clipped
    return [(torch.rand(g.shape, generator=gen) * (2.0 * clip) - clip).abs().to(g.device)
            for g in grads]


def _one_minus_pow(b: float, t: int) -> torch.Tensor:
    f32 = torch.float32
    return torch.tensor(1.0, dtype=f32) - torch.tensor(b, dtype=f32) ** torch.tensor(float(t), dtype=f32)


@dataclasses.dataclass
class Adam:
    """Adam moments of one net's parameters (a list of tensors)."""
    m: list
    v: list
    count: int = 0


def tf1_adam(params, grads, st: Adam, t: int, lr, b1, b2, eps) -> None:
    """TF1's Adam at bias-correction step t: eps outside the correction,
    lr_t in float32."""
    lr_t = float(torch.tensor(lr, dtype=torch.float32) * torch.sqrt(_one_minus_pow(b2, t))
                 / _one_minus_pow(b1, t))
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(params, grads)):
            st.m[i] = b1 * st.m[i] + (1.0 - b1) * g
            st.v[i] = b2 * st.v[i] + (1.0 - b2) * g * g
            p.sub_(lr_t * st.m[i] / (torch.sqrt(st.v[i]) + eps))
    st.count += 1


def optax_adam(params, grads, st: Adam, lr, b1, b2, eps) -> None:
    """optax.adam: eps added to sqrt(v_hat), float32 bias corrections."""
    st.count += 1
    bc1 = float(_one_minus_pow(b1, st.count))
    bc2 = float(_one_minus_pow(b2, st.count))
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(params, grads)):
            st.m[i] = b1 * st.m[i] + (1.0 - b1) * g
            st.v[i] = b2 * st.v[i] + (1.0 - b2) * g * g
            p.add_(-lr * (st.m[i] / bc1) / (torch.sqrt(st.v[i] / bc2) + eps))


def adam_state(params) -> Adam:
    return Adam([torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


class Game:
    """The game's state: the three nets, both players' Adam, the draws'
    generator. `sub_step` follows the learner's alternation."""

    def __init__(self, cfg: dict, n: dict, seed: int):
        self.cfg, self.n = cfg, n
        for net in n.values():
            net.requires_grad_(False)
        self.gen = torch.Generator().manual_seed(seed)
        self.params = {k: list(n[k].parameters()) for k in ("generator", "recover")}
        self.adam = {k: adam_state(v) for k, v in self.params.items()}
        self.sub_steps = 0

    def player(self, sub_step: int) -> str:
        c = self.cfg
        return "recover" if sub_step % (c["iters_rec"] + c["iters_gen"]) < c["iters_rec"] \
            else "generator"

    def step(self, img1, img2, draw_rows: int | None = None):
        """One sub-step; returns (player, losses before the update). The
        draws are made for `draw_rows` rows (default: the batch's) and the
        batch's first rows take them."""
        cfg, n = self.cfg, self.n
        self.sub_steps += 1
        who = self.player(self.sub_steps)
        b, h, w, _ = img1.shape
        draws = sample_augment(self.gen, draw_rows or b, h, w, cfg["train_crop"])
        img1, img2 = augment_pair({k: v[:b] for k, v in draws.items()}, img1, img2)
        net = n[who]
        net.requires_grad_(True)
        try:
            with torch.no_grad():
                flow = n["pwc"](img1, img2)
            size = (cfg["img_height"], cfg["img_width"])
            image = resize_bilinear(img1, size)
            flow = resize_bilinear(flow, size) / cfg["flow_normalizer"]
            losses = game_losses(cfg, n, image, flow)
            grads = torch.autograd.grad(losses[who], self.params[who])
        finally:
            net.requires_grad_(False)
        grads = clip_or_noise(self.gen, grads, cfg["gradient_clip"],
                              cfg["grad_noise_threshold"], who == "generator")
        t = self.adam["generator"].count + self.adam["recover"].count + 1
        tf1_adam(self.params[who], grads, self.adam[who], t, cfg["learning_rate"],
                 cfg["beta1"], 0.999, cfg["adam_epsilon"])
        return who, {k: float(v.detach()) for k, v in losses.items()}


# --- PWC pretraining ---------------------------------------------------------------
def _upsample_linear(base: np.ndarray, height: int, width: int, device) -> torch.Tensor:
    x = torch.from_numpy(base).to(device).permute(0, 3, 1, 2)
    up = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)


def scene(rng: np.random.RandomState, batch: int, height: int, width: int,
          max_mag: float, device):
    """(img1, img2, flow) with I2(p) = I1(p + F(p)): two textures upsampled
    x8 and x2, F affine plus a sinusoid clipped to +-max_mag pixels,
    channels (dy, dx); the RandomState calls in the order of the port's
    `synthetic_flow_batch`, F evaluated in float64."""
    def texture(scale, amp):
        base = rng.rand(batch, height // scale, width // scale, 3).astype(np.float32)
        return amp * (_upsample_linear(base, height, width, device) - 0.5)

    img1 = torch.clamp(texture(8, 0.7) + texture(2, 0.3), -0.5, 0.5)
    yn = ((np.arange(height, dtype=np.float32) - height / 2) / height).astype(np.float64)
    xn = ((np.arange(width, dtype=np.float32) - width / 2) / width).astype(np.float64)
    field = np.empty((batch, height, width, 2), np.float64)
    for b in range(batch):
        for ch in range(2):
            a = rng.uniform(-0.5, 0.5) * max_mag
            lin = rng.uniform(-0.5, 0.5, 2) * max_mag
            amp = rng.uniform(-0.3, 0.3) * max_mag
            fy, fx = rng.uniform(1.0, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            field[b, :, :, ch] = (a + lin[0] * yn[:, None] + lin[1] * xn[None, :]
                                  + amp * np.sin(2 * np.pi * fy * yn + ph[0])[:, None]
                                  * np.cos(2 * np.pi * fx * xn + ph[1])[None, :])
    flow = torch.clamp(torch.from_numpy(field).to(device).float(), -max_mag, max_mag)
    with torch.no_grad():
        img2 = dense_image_warp(img1, -flow)
    return img1, img2, flow


def pwc_loss(pwc, img1, img2, flow_gt, aux_weight: float = 0.1):
    """(loss, epe): final EPE plus aux_weight x each level's EPE against
    resize(F)/20 (/2**flow_pred_lvl at the output level)."""
    flow, pyr = pwc(img1, img2, return_pyramid=True)
    epe = torch.linalg.vector_norm(flow - flow_gt, dim=-1).mean()
    aux = 0.0
    for i, f in enumerate(pyr):
        scale = 2.0**pwc.flow_pred_lvl if i == len(pyr) - 1 else 20.0
        target = resize_bilinear(flow_gt, (f.shape[1], f.shape[2])) / scale
        aux = aux + torch.linalg.vector_norm(f - target, dim=-1).mean()
    return epe + aux_weight * aux, epe


def pretrain_step(cfg: dict, pwc, adam: Adam, img1, img2, flow_gt):
    """One optax-Adam update of PWC-Net; returns the loss before it."""
    params = list(pwc.parameters())
    loss, _ = pwc_loss(pwc, img1, img2, flow_gt)
    grads = torch.autograd.grad(loss, params)
    optax_adam(params, grads, adam, cfg["learning_rate"], cfg["beta1"], 0.999,
               cfg["adam_epsilon"])
    return float(loss.detach())


def gap(a: float, b: float, floor: float = 0.0) -> float:
    """|a - b| over the larger of |b| and `floor`; 0 where both are equal."""
    if a == b:
        return 0.0
    scale = max(abs(b), floor)
    return abs(a - b) / scale if scale else math.inf
