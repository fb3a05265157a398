"""What the entries share: the program's Config from a cell's files, the
reference's float32 scope, the comparisons, and the FLOP count."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

# XLA's count of the JAX package's flagship forward, as the JAX package's
# own benchmark recorded it; printed beside the port's count for reference only
XLA_GFLOP_PER_FRAME = 117.91


def seeds(seed: int, n: int) -> list[int]:
    """n independent 32-bit seeds drawn from one run seed of any size."""
    return [int(x) for x in np.random.SeedSequence(seed).generate_state(n)]


@contextlib.contextmanager
def phase(log, what: str):
    """Log the seconds a phase of set-up takes."""
    t0 = time.monotonic()
    yield
    log(f"setup: {what} {time.monotonic() - t0:.3f} s")


def program_config(cell, seed: int, **extra):
    """The port's Config for the cell: every field that the configuration
    file names, the workload's compute dtype, the seed, then `extra`."""
    from unsupervised_detection_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    values = {k: v for k, v in cell.config.items() if k in fields}
    values.update(compute_dtype=cell.spec["compute_dtype"], seed=seed, **extra)
    return Config(**values)


@contextlib.contextmanager
def float32_scope():
    """Full float32 for cuDNN and matmuls (TF32 off), restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def abs_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def abs_mean(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().mean())


def rel_mean(got: torch.Tensor, want: torch.Tensor) -> float:
    """mean |got - want| over mean |want|."""
    want = want.double()
    return float((got.double() - want).abs().mean() / want.abs().mean().clamp(min=1e-30))


def leaf_norms(tensors: dict) -> dict:
    """{name: float64 L2 norm} of each tensor."""
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """{leaf: |got - want| over the larger of the reference's norm of that
    leaf and of the median leaf}, over the leaves in `keep` (all where
    None); a leaf missing on the program's side reads 1."""
    names = [k for k in want if keep is None or k in keep]
    median = float(np.median([want[k] for k in names])) if names else 0.0
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) if k in got else 1.0
            for k in names}


def worst_leaf(got: dict, want: dict, keep=None) -> float:
    """The largest of `leaf_gaps`; inf where no leaf is compared."""
    gaps = leaf_gaps(got, want, keep)
    return max(gaps.values()) if gaps else math.inf


def net_gap(got: dict, want: dict, keep=None) -> float:
    """|norm - norm| / norm of the whole net over the leaves in `keep`."""
    names = [k for k in want if keep is None or k in keep]
    g = math.sqrt(sum(got.get(k, 0.0) ** 2 for k in names))
    w = math.sqrt(sum(want[k] ** 2 for k in names))
    return abs(g - w) / w if w else math.inf


def describe_worst(log, what: str, got: dict, want: dict, keep=None) -> None:
    """Log the leaf that sets the worst gap, with both norms."""
    gaps = leaf_gaps(got, want, keep)
    if gaps:
        k = max(gaps, key=gaps.get)
        median = float(np.median([want[n] for n in gaps]))
        log(f"{what}: worst leaf {k} gap {gaps[k]:.3e}, program {got.get(k, 0.0):.6e}, "
            f"reference {want[k]:.6e}, median leaf {median:.6e}, leaves {len(gaps)}")


def moved_leaves(first_grad: dict, share: float = 1e-3) -> set:
    """The leaves whose first gradient in the reference is at least `share`
    of the median leaf's: the others move under Adam by round-off alone."""
    median = float(np.median(list(first_grad.values())))
    return {k for k, v in first_grad.items() if v >= share * median}


def launches() -> tuple:
    """The program's launch counters of its four kernels on the card: (cost
    volume, warp, cost volume backward, warp backward); a check of the
    path, not a metric."""
    from unsupervised_detection_tpu_torch.ops.cost_volume import (cost_volume,
                                                                  cost_volume_backward)
    from unsupervised_detection_tpu_torch.ops.warp import dense_image_warp, warp_backward

    return (cost_volume.launches, dense_image_warp.launches, cost_volume_backward.launches,
            warp_backward.launches)


def count_flops(fn) -> float:
    """FLOPs that torch.utils.flop_counter counts while fn() runs (the
    custom kernels, called through ctypes, are not among them)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
