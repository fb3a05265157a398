"""Batched train-time augmentation on the device, counterpart of
unsupervised_detection_tpu/ops/augment.py (reference data/aug_flips.py and
data/davis2016_data_utils.py:101-146): an identical random flip of both
frames (identity, rot180, left-right, top-down, 1/4 each), then an
identical random crop by a fraction p ~ U[train_crop, 1) with continuous
offsets, resized back with per-sample bilinear matrices.

Each transform is a sampler and an apply function. The samplers draw from
an explicit `torch.Generator`, in the order flip case, p, y0, x0; the
apply functions take those draws as (B,) tensors. JAX draws from its own
PRNG, so the tests feed the apply functions draws that JAX's calls made
from JAX's key.
"""

from __future__ import annotations

import torch

from .resize import crop_resize_matrices


def sample_flip(gen: torch.Generator, b: int) -> torch.Tensor:
    """(B,) int64 flip cases in {0: identity, 1: rot180, 2: lr, 3: td}."""
    return torch.randint(0, 4, (b,), generator=gen, device=gen.device)


def sample_crop(gen: torch.Generator, b: int, h: int, w: int, min_crop_fraction: float):
    """(p, y0, x0), each (B,) float32: the crop fraction
    p = min + u (1 - min), and offsets y0 = u' (h - h p), x0 = u'' (w - w p)."""
    u = torch.rand((3, b), generator=gen, device=gen.device)
    p = min_crop_fraction + u[0] * (1.0 - min_crop_fraction)
    return p, u[1] * (h - h * p), u[2] * (w - w * p)


def sample_augment(gen: torch.Generator, b: int, h: int, w: int,
                   min_crop_fraction: float) -> dict[str, torch.Tensor]:
    """All draws of one `augment_pair`: {case, p, y0, x0}."""
    case = sample_flip(gen, b)
    p, y0, x0 = sample_crop(gen, b, h, w, min_crop_fraction)
    return {"case": case, "p": p, "y0": y0, "x0": x0}


def random_flip_pair(case: torch.Tensor, img1: torch.Tensor, img2: torch.Tensor):
    """The flip of each sample's `case` applied to both NHWC frames."""
    flip_lr = ((case == 1) | (case == 2))[:, None, None, None]
    flip_td = ((case == 1) | (case == 3))[:, None, None, None]

    def apply(img):
        img = torch.where(flip_lr, img.flip(2), img)
        return torch.where(flip_td, img.flip(1), img)

    return apply(img1), apply(img2)


def random_crop_resize_pair(p: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                            img1: torch.Tensor, img2: torch.Tensor):
    """Crop both NHWC frames to the window (y0, x0, h p, w p) and resize it
    back to (h, w); edge taps stay inside the window."""
    _, h, w, _ = img1.shape
    wh = crop_resize_matrices(h, h, p, y0, clamp_lo=y0, clamp_hi=y0 + h * p - 1.0)
    ww = crop_resize_matrices(w, w, p, x0, clamp_lo=x0, clamp_hi=x0 + w * p - 1.0)

    def apply(img):
        y = torch.einsum("boh,bhwc->bowc", wh.to(img.dtype), img)
        return torch.einsum("bpw,bowc->bopc", ww.to(img.dtype), y)

    return apply(img1), apply(img2)


def augment_pair(draws: dict[str, torch.Tensor], img1: torch.Tensor, img2: torch.Tensor):
    """Flip, then crop+resize, with the draws of `sample_augment` (moved to
    the frames' device)."""
    d = {k: v.to(img1.device) for k, v in draws.items()}
    img1, img2 = random_flip_pair(d["case"], img1, img2)
    return random_crop_resize_pair(d["p"], d["y0"], d["x0"], img1, img2)
