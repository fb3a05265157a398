"""The synthetic scenes of the recipe that made the flagship, counterpart of
the JAX repo's experiment generators:

  * `game_draws` / `render_game` -- tools/exp_convergence_v2.py
    `make_batch_fn` (:80-134): a textured background under a random affine
    flow and one textured square of side `square` carrying an independent
    affine flow; the two-player game's scenes, with or without the second
    frame (`with_pairs`);
  * `v2_draws` / `render_v2` -- tools/exp_scenes.py `make_scenes_v2`
    (:43-138): 1..max_objects rectangles in painter's order, each with its
    own texture and affine flow (plus a low-frequency sinusoid with
    `deform_amp`, scenes v3), photometric noise on frame 2; PWC
    pretraining's scenes.

Each generator is split in two. The draws are a dict of float32 / int64 /
bool CPU tensors made from an explicit `torch.Generator`, in the shapes
and ranges of the tools' `jax.random` calls (integer bounds exclusive
above, as `jax.random.randint`), so one seed gives one batch on every
device. The render is a pure function of the draws on `device` (None =
the card; raises without one), always in float32 whatever the nets'
dtype: textures upsampled with half-pixel centres (`jax.image.resize`
"linear", which is `F.interpolate(..., "bilinear", align_corners=False)`
for an upsample), affine fields a + b*xn + c*yn with xn = (x - W/2)/W and
yn = (y - H/2)/H, flows channel 0 = y, I2 = dense_image_warp(I1, -F) (one
launch of the port's warp kernel on the card) so that I2(p) = I1(p + F(p)).
Flows are returned divided by 80 (the game's flow normalizer); they reach
about +-36 px.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.warp import dense_image_warp

FLOW_SCALE = 80.0            # flows come back / 80, the game's normalizer
BG_AMP = 12.0                # affine constant term of the background, px
OBJ_AMP = 20.0               # ... and of an object
LIN_AMP = 16.0               # linear terms of both


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _texture_draws(gen: torch.Generator, batch: int, h: int, w: int, scale: int):
    return torch.rand((batch, h // scale, w // scale, 3), generator=gen)


def _texture(base: torch.Tensor, h: int, w: int, amp: float) -> torch.Tensor:
    """amp * (upsample(base) - 0.5), (B, H, W, 3)."""
    up = F.interpolate(base.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)
    return amp * (up - 0.5)


def _grids(h: int, w: int, device):
    """Integer iotas (1, H, 1) and (1, 1, W) on `device`, and the
    normalised float32 coordinates yn (1, H, 1, 1) and xn (1, 1, W, 1) on
    the host: a division by a scalar on the card multiplies by its
    reciprocal, so the host's correctly rounded one keeps the render one
    function on every device."""
    yy = torch.arange(h, device=device).view(1, h, 1)
    xx = torch.arange(w, device=device).view(1, 1, w)
    yn = (torch.arange(h, dtype=torch.float32) - h / 2) / h
    xn = (torch.arange(w, dtype=torch.float32) - w / 2) / w
    return yy, xx, yn.view(1, h, 1, 1), xn.view(1, 1, w, 1)


def _affine(co: torch.Tensor, amp_a: float, yn, xn) -> torch.Tensor:
    """(B, H, W, 2) field from (B, 2, 3) coefficients in [-1, 1) on the
    device: co*[amp_a, 16, 16] -> a + b*xn + c*yn per channel."""
    co = co * torch.tensor([amp_a, LIN_AMP, LIN_AMP], dtype=torch.float32, device=co.device)
    yn, xn = yn.to(co.device), xn.to(co.device)
    return (co[:, None, None, :, 0] + co[:, None, None, :, 1] * xn
            + co[:, None, None, :, 2] * yn)


def _box(yy, xx, y0, x0, side_y, side_x) -> torch.Tensor:
    """(B, H, W) bool: y0 <= y < y0 + side_y and x0 <= x < x0 + side_x."""
    return (yy >= y0) & (yy < y0 + side_y) & (xx >= x0) & (xx < x0 + side_x)


def _to(draws: dict, device) -> dict:
    return {k: v.to(device) for k, v in draws.items()}


# --- the game's scenes (exp_convergence_v2.make_batch_fn) ---------------------
def game_draws(gen: torch.Generator, batch: int, height: int, width: int,
               square: int) -> dict:
    """The random draws of one game batch, in the tool's key order
    (ks[0..7]): two background textures (x8, x2), the square's texture
    (x4) and brightness offset, its corner (y0 in [0, H - square), x0 in
    [0, W - square)), the background's and the square's affine
    coefficients."""
    return {
        "bg8": _texture_draws(gen, batch, height, width, 8),
        "bg2": _texture_draws(gen, batch, height, width, 2),
        "tex": _texture_draws(gen, batch, height, width, 4),
        "offset": _uniform(gen, (batch, 1, 1, 1), -0.2, 0.2),
        "y0": torch.randint(0, height - square, (batch, 1, 1), generator=gen),
        "x0": torch.randint(0, width - square, (batch, 1, 1), generator=gen),
        "co_bg": _uniform(gen, (batch, 2, 3), -1.0, 1.0),
        "co_obj": _uniform(gen, (batch, 2, 3), -1.0, 1.0),
    }


def render_game(draws: dict, height: int, width: int, square: int,
                with_pairs: bool = False, device=None, background_flow: bool = False):
    """The tool's batch from `game_draws`: (img, flow / 80, gt), or with
    `with_pairs` (img1, img2, flow / 80, gt); img in [-0.5, 0.5], gt the
    square as (B, H, W, 1) float32 {0, 1}. With `background_flow` the
    background's own field / 80 (what the square would have moved by) is
    appended, for the diagnostic's "did PWC see the object" share."""
    device = resolve_device(device)
    d = _to(draws, device)
    yy, xx, yn, xn = _grids(height, width, device)
    img_bg = _texture(d["bg8"], height, width, 0.6) + _texture(d["bg2"], height, width, 0.25)
    sq_tex = _texture(d["tex"], height, width, 0.7) + d["offset"]
    inside = _box(yy, xx, d["y0"], d["x0"], square, square)
    gt = inside.to(torch.float32)[..., None]
    img = torch.clamp(torch.where(gt > 0, sq_tex, img_bg), -0.5, 0.5)
    flow_bg = _affine(d["co_bg"], BG_AMP, yn, xn)
    flow = torch.where(gt > 0, _affine(d["co_obj"], OBJ_AMP, yn, xn), flow_bg)
    out = (img, flow / FLOW_SCALE, gt)
    if with_pairs:
        with torch.no_grad():
            img2 = dense_image_warp(img, -flow)
        out = (img, img2, flow / FLOW_SCALE, gt)
    if background_flow:
        out = out + (flow_bg / FLOW_SCALE,)
    return out


def game_batch(gen: torch.Generator, batch: int, height: int, width: int, square: int,
               with_pairs: bool = False, device=None):
    """`render_game(game_draws(...))`."""
    return render_game(game_draws(gen, batch, height, width, square), height, width, square,
                       with_pairs, device)


# --- scenes v2 / v3 (exp_scenes.make_scenes_v2) --------------------------------
def v2_draws(gen: torch.Generator, batch: int, height: int, width: int,
             max_objects: int = 3, bright: float = 0.05,
             deform_amp: float = 0.0) -> dict:
    """The random draws of one v2 batch (v3 with `deform_amp`): the
    background's two textures and affine coefficients, then per object,
    stacked on a leading axis of `max_objects`: sides in [H/8, H/2],
    corners y0 in [0, H - H/8) and x0 in [0, W - H/8), activity (object 0
    always; the others with probability 1/2), texture (x4) and brightness
    offset, affine coefficients and, for v3, the sinusoid's amplitude
    factor in [0.3, 1), frequencies in [1, 3) and phases in [0, 2 pi);
    last the frame-2 brightness shift in [-bright, bright) and the
    per-pixel standard normal noise."""
    h8, n = height // 8, max_objects
    out = {"bg8": _texture_draws(gen, batch, height, width, 8),
           "bg2": _texture_draws(gen, batch, height, width, 2),
           "co_bg": _uniform(gen, (batch, 2, 3), -1.0, 1.0)}
    objs = {k: [] for k in ("side_y", "side_x", "y0", "x0", "active", "tex", "offset", "co")}
    if deform_amp:
        objs.update(amp=[], freq=[], phase=[])
    for i in range(n):
        objs["side_y"].append(torch.randint(h8, height // 2 + 1, (batch, 1, 1), generator=gen))
        objs["side_x"].append(torch.randint(h8, height // 2 + 1, (batch, 1, 1), generator=gen))
        objs["y0"].append(torch.randint(0, height - h8, (batch, 1, 1), generator=gen))
        objs["x0"].append(torch.randint(0, width - h8, (batch, 1, 1), generator=gen))
        objs["active"].append(torch.ones((batch, 1, 1), dtype=torch.bool) if i == 0 else
                              torch.rand((batch, 1, 1), generator=gen) < 0.5)
        objs["tex"].append(_texture_draws(gen, batch, height, width, 4))
        objs["offset"].append(_uniform(gen, (batch, 1, 1, 1), -0.2, 0.2))
        objs["co"].append(_uniform(gen, (batch, 2, 3), -1.0, 1.0))
        if deform_amp:
            objs["amp"].append(_uniform(gen, (batch, 1, 1, 2), 0.3, 1.0))
            objs["freq"].append(_uniform(gen, (batch, 1, 1, 2, 2), 1.0, 3.0))
            objs["phase"].append(_uniform(gen, (batch, 1, 1, 2, 2), 0.0, 2 * math.pi))
    out.update({"obj_" + k: torch.stack(v) for k, v in objs.items()})
    out["bright"] = _uniform(gen, (batch, 1, 1, 1), -bright, bright)
    out["noise"] = torch.randn((batch, height, width, 3), generator=gen)
    return out


def _sinusoid(amp, freq, phase, deform_amp: float, yn, xn, device) -> torch.Tensor:
    """deform_amp * amp * (sin(2 pi fy yn + phy) * cos(2 pi fx xn + phx))
    per channel from the host's draws: the sine of each row and the cosine
    of each column on the host (the card's sin and cos round otherwise),
    their product on `device`."""
    two_pi = 2 * math.pi
    a = (deform_amp * amp).to(device)
    rows = torch.sin(two_pi * freq[..., 0] * yn + phase[..., 0]).to(device)    # (B, H, 1, 2)
    cols = torch.cos(two_pi * freq[..., 1] * xn + phase[..., 1]).to(device)    # (B, 1, W, 2)
    return a * (rows * cols)


def render_v2(draws: dict, height: int, width: int, noise: float = 0.02,
              deform_amp: float = 0.0, device=None):
    """The tool's (img1, img2, flow / 80, object mask) from `v2_draws`:
    objects overdraw earlier ones (painter's order), sides cut to the frame
    (`side = min(side, H - y0)`), the object mask the union of the active
    rectangles; frame 2 warped from frame 1, shifted in brightness, noised
    and clipped to [-0.5, 0.5]."""
    device = resolve_device(device)
    d = _to(draws, device)
    yy, xx, yn, xn = _grids(height, width, device)
    img = torch.clamp(_texture(d["bg8"], height, width, 0.6)
                      + _texture(d["bg2"], height, width, 0.25), -0.5, 0.5)
    flow = _affine(d["co_bg"], BG_AMP, yn, xn)
    obj_mask = torch.zeros((img.shape[0], height, width, 1), device=device)
    for i in range(d["obj_y0"].shape[0]):
        y0, x0 = d["obj_y0"][i], d["obj_x0"][i]
        side_y = torch.minimum(d["obj_side_y"][i], height - y0)
        side_x = torch.minimum(d["obj_side_x"][i], width - x0)
        inside = _box(yy, xx, y0, x0, side_y, side_x)
        m = (inside & d["obj_active"][i]).to(torch.float32)[..., None]
        tex = _texture(d["obj_tex"][i], height, width, 0.7) + d["obj_offset"][i]
        img = torch.clamp(torch.where(m > 0, tex, img), -0.5, 0.5)
        obj_flow = _affine(d["obj_co"][i], OBJ_AMP, yn, xn)
        if deform_amp:
            obj_flow = obj_flow + _sinusoid(draws["obj_amp"][i], draws["obj_freq"][i],
                                            draws["obj_phase"][i], deform_amp, yn, xn, device)
        flow = torch.where(m > 0, obj_flow, flow)
        obj_mask = torch.maximum(obj_mask, m)
    with torch.no_grad():
        img2 = dense_image_warp(img, -flow)
    img2 = img2 + d["bright"]
    img2 = img2 + noise * d["noise"]
    img2 = torch.clamp(img2, -0.5, 0.5)
    return img, img2, flow / FLOW_SCALE, obj_mask


def v2_batch(gen: torch.Generator, batch: int, height: int, width: int,
             deform_amp: float = 0.0, device=None):
    """`render_v2(v2_draws(...))` at the tool's defaults (3 objects, noise
    0.02, brightness 0.05)."""
    return render_v2(v2_draws(gen, batch, height, width, deform_amp=deform_amp),
                     height, width, deform_amp=deform_amp, device=device)
