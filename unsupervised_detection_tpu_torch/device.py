"""Device selection and float32 precision for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: `None`
resolves to "cuda", and a missing card raises instead of quietly falling
back to the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the first CUDA device; raise when the requested CUDA device
    does not exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return dev


@contextlib.contextmanager
def precision_scope(dtype: torch.dtype):
    """Within the scope, float32 convolutions and matmuls run in full float32.

    The JAX package asks for Precision.HIGHEST in float32
    (models/layers.py:23-26); cuDNN would otherwise use TF32 for float32
    convolutions. The previous settings are restored on exit. bfloat16
    leaves them alone.
    """
    if dtype != torch.float32:
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def compute_dtype(name: str) -> torch.dtype:
    """Config.compute_dtype string -> torch dtype."""
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got {name!r}")
