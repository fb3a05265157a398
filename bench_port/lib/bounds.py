"""The custom kernels' least times, bytes and operations, from their shapes.

Copied from chip_smoke.py (`bound_ms`, `cost_bound`, `warp_bound`,
`cost_backward_bound`, `warp_backward_bound`, and the H100 peaks beside
them) and frozen here, so that a change to the program cannot move the
yardstick. Each input byte is read once and each output byte written once;
the operations are those the algorithm needs. Sizes are plain numbers and
`item` is the element size in bytes (4 float32, 2 bfloat16).
"""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM3 3.35 TB/s; float32
# outside the tensor cores 67 TFLOP/s; bfloat16 989 TFLOP/s.
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEM_BYTES = {"float32": 4, "bfloat16": 2}

# PWC-Net's feature pyramid widths by level (models/pwcnet.py, the reference's
# model_pwcnet.py): level l holds the frame at 1 / 2**l of its size
PYRAMID_CHANNELS = {1: 16, 2: 32, 3: 64, 4: 96, 5: 128, 6: 196}


def bound_s(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """Least seconds for the work: the larger of bytes over the memory rate
    and operations over the dtype's peak; and which of the two it is."""
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cost_volume(b, h, w, c, r, item):
    """(bytes, operations) of one cost volume: reads c1 and the warped
    features, writes (2r+1)**2 costs per pixel; one multiply-add per
    channel and displacement."""
    k = (2 * r + 1) ** 2
    return (2 * b * h * w * c + b * h * w * k) * item, 2.0 * b * h * w * c * k


def warp(b, h, w, c, item):
    """(bytes, operations) of one bilinear warp: reads the image and the
    flow, writes the image; 3 lerps of 3 operations per output element and
    ~10 per pixel for the coordinates."""
    return 2 * b * h * w * c * item + b * h * w * 2 * item, 9.0 * b * h * w * c + 10.0 * b * h * w


def cost_volume_backward(b, h, w, c, r, item):
    """(bytes, operations) of the cost volume's VJP: reads c1, the warped
    features, the output and its gradient, writes both input gradients;
    one multiply-add per pair and gradient."""
    k = (2 * r + 1) ** 2
    return (4 * c + 2 * k) * b * h * w * item, 4.0 * b * h * w * c * k


def warp_backward(b, h, w, c, item):
    """(bytes, operations) of the warp's VJP: reads image, flow and the
    gradient, writes both input gradients; ~20 operations per element."""
    return (3 * c + 4) * b * h * w * item, 20.0 * b * h * w * c


def pwc_levels(reader_h: int, reader_w: int, pyr_lvls: int, flow_pred_lvl: int):
    """(level, H, W, C) of the levels where PWC-Net builds a cost volume,
    coarse to fine; the warp runs on every one of them but the top."""
    return [(lvl, reader_h >> lvl, reader_w >> lvl, PYRAMID_CHANNELS[lvl])
            for lvl in range(pyr_lvls, flow_pred_lvl - 1, -1)]


def _work(calls, dtype):
    """(calls, bytes, operations, least seconds, what bounds them) of a list
    of one kernel's (bytes, operations) per call; the least time is the sum
    of each call's."""
    least = [bound_s(nbytes, ops, dtype) for nbytes, ops in calls]
    kinds = {kind for _, kind in least}
    return (len(calls), sum(x for x, _ in calls), sum(y for _, y in calls),
            sum(t for t, _ in least), "/".join(sorted(kinds)))


def pwc_forward_work(b, reader_h, reader_w, pyr_lvls, flow_pred_lvl, r, dtype):
    """{kernel: _work(...)} of one PWC-Net forward at batch `b` in `dtype`:
    one cost volume per level, one warp per level below the top."""
    item = ITEM_BYTES[dtype]
    levels = pwc_levels(reader_h, reader_w, pyr_lvls, flow_pred_lvl)
    return {"cost_volume": _work([cost_volume(b, h, w, c, r, item) for _, h, w, c in levels],
                                 dtype),
            "warp": _work([warp(b, h, w, c, item) for _, h, w, c in levels[1:]], dtype)}


def pwc_backward_work(b, reader_h, reader_w, pyr_lvls, flow_pred_lvl, r, dtype):
    """{kernel: _work(...)} of one backward pass through PWC-Net's custom
    kernels at batch `b` in `dtype`."""
    item = ITEM_BYTES[dtype]
    levels = pwc_levels(reader_h, reader_w, pyr_lvls, flow_pred_lvl)
    return {"cost_volume_backward": _work(
                [cost_volume_backward(b, h, w, c, r, item) for _, h, w, c in levels], dtype),
            "warp_backward": _work(
                [warp_backward(b, h, w, c, item) for _, h, w, c in levels[1:]], dtype)}
