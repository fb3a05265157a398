"""What the per-layer metrics compute from a traced run's context.

The entry hands each reader a dict: `window` (the profiled window,
lib/trace.py), `dtype`, `flops_per_step` (counted at set-up), the least
seconds per step of each custom kernel (`least_s_per_step`), and the host
spans and CUDA-event times of the measured window (`spans_s`, `step_ms`).
A reader that finds nothing to read returns None, and the metric is left
out of the line; a share of a roofline or of a peak is never made up.
"""

from __future__ import annotations

from .bounds import PEAK_FLOPS
from .stats import mean

# the device symbols of the custom kernels (csrc/*.cu)
SYMBOLS = {"cost_volume": "cost_volume_kernel",
           "cost_volume_backward": "cost_volume_backward_kernel",
           "warp": "warp_kernel", "warp_backward": "warp_backward_kernel"}


def span_ms(ctx: dict, name: str):
    values = ctx.get("spans_s", {}).get(name)
    return mean(values) * 1e3 if values else None


def step_ms(ctx: dict, player: str):
    values = ctx.get("step_ms", {}).get(player)
    return mean(values) if values else None


def mfu(ctx: dict):
    """The step's FLOPs per second over the traced window, as a share of
    the dtype's dense peak (%)."""
    w = ctx["window"]
    if not ctx.get("flops_per_step") or w.window_s <= 0:
        return None
    return 100.0 * ctx["flops_per_step"] * w.steps / w.window_s / PEAK_FLOPS[ctx["dtype"]]


def roofline(ctx: dict, kernel: str):
    """The kernel's least time by its bytes and operations over the time the
    card spent in it, in the traced window (%)."""
    w = ctx["window"]
    least = ctx.get("least_s_per_step", {}).get(kernel)
    spent = w.kernel_s(SYMBOLS[kernel])
    if not least or spent <= 0:
        return None
    return 100.0 * least * w.steps / spent


def idle_share(ctx: dict):
    """The share of the traced window in which nothing ran on the card (%)."""
    w = ctx["window"]
    if w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.window_s)
