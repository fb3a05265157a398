"""The cells' inputs, made from the seed.

`eval_frames` is copied from chip_smoke.py's `eval_batches` and frozen
here: raw uint8 frames at DAVIS 2016's 480p size, a textured square moving
over a panning textured background, and 0/255 masks, held in host memory
by name, as a decoder would hand them to the evaluation pipeline.
`pair_pool` makes the training cell's frame pairs on the device. Neither
imports the program.
"""

from __future__ import annotations

import numpy as np
import torch


def _texture(rs: np.random.RandomState, shape) -> np.ndarray:
    t = rs.rand(*shape).astype(np.float32)
    for axis in (0, 1):            # box blur along H and W
        t = (t + np.roll(t, 1, axis) + np.roll(t, -1, axis)) / 3.0
    return (t * 255.0).astype(np.uint8)


def eval_frames(rs: np.random.RandomState, categories: int, frames: int, stored: int,
                raw_hw, side: int):
    """(frames by name, [category names], [[frame names] per category]):
    `categories` sequences of `frames` names each; name f of a sequence
    shows stored frame f % `stored`, so a long sequence costs the memory of
    `stored` frames. Masks are under the frame's name + '.mask'."""
    h, w = raw_hw
    arrays, names = {}, []
    for c in range(categories):
        bg, fg = _texture(rs, (h, w, 3)), _texture(rs, (side, side, 3))
        y0, x0 = rs.randint(0, h - side - 6 * stored), rs.randint(0, w - side - 12 * stored)
        held = []
        for f in range(stored):
            y, x = y0 + 6 * f, x0 + 12 * f
            img = np.roll(bg, (2 * f, 3 * f), axis=(0, 1))
            img[y:y + side, x:x + side] = fg
            mask = np.zeros((h, w, 1), np.uint8)
            mask[y:y + side, x:x + side] = 255
            held.append((img, mask))
        names.append([f"cat{c}/{f:05d}" for f in range(frames)])
        for f, name in enumerate(names[-1]):
            arrays[name], arrays[name + ".mask"] = held[f % stored]
    return arrays, [f"cat{c}" for c in range(categories)], names


def _smooth(gen: torch.Generator, b: int, h: int, w: int, scale: int, device) -> torch.Tensor:
    """(b, h, w, 3) texture in [-0.5, 0.5]: uniform noise at 1/scale,
    upsampled bilinearly."""
    base = torch.rand((b, 3, h // scale, w // scale), generator=gen, device=device)
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1) - 0.5


def pair_pool(gen: torch.Generator, pairs: int, hw, side: int, max_shift: int, device):
    """(img1, img2), each (pairs, H, W, 3) float32 in [-0.5, 0.5] on
    `device`: a textured background panned by a random shift and a textured
    square moved by another, so that the two motions differ."""
    h, w = hw
    m = max_shift
    bg = 0.7 * _smooth(gen, pairs, h + 2 * m, w + 2 * m, 8, device) \
        + 0.3 * _smooth(gen, pairs, h + 2 * m, w + 2 * m, 2, device)
    fg = 0.8 * _smooth(gen, pairs, side, side, 4, device)
    pos = torch.rand((pairs, 2), generator=gen, device=device)
    shifts = torch.randint(-m, m + 1, (pairs, 4), generator=gen, device=device)
    pos, shifts = pos.cpu().numpy(), shifts.cpu().numpy()
    img1 = torch.empty((pairs, h, w, 3), device=device)
    img2 = torch.empty_like(img1)
    for i in range(pairs):
        y, x = int(pos[i, 0] * (h - side - 2 * m)) + m, int(pos[i, 1] * (w - side - 2 * m)) + m
        dy, dx, oy, ox = (int(s) for s in shifts[i])
        img1[i] = bg[i, m:m + h, m:m + w]
        img2[i] = bg[i, m + dy:m + dy + h, m + dx:m + dx + w]
        img1[i, y:y + side, x:x + side] = fg[i]
        img2[i, y + oy:y + oy + side, x + ox:x + ox + side] = fg[i]
    return img1, img2
