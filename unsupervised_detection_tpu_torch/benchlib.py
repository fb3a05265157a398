"""Builder and timer for the flagship forward (PWC flow + generator mask),
counterpart of unsupervised_detection_tpu/benchlib.py:27-104.

The program is the reference's benchmarked configuration: PWCNet flow at
the reader resolution (640x384) and the generator mask at the working
resolution (384x192) per frame pair (reference
models/adversarial_learner.py:82-107).
"""

from __future__ import annotations

import numpy as np
import torch

from .convert import from_jax_params, random_jax_params
from .device import precision_scope
from .train.objective import AdversarialObjective


def build_forward(cfg, device=None, seed: int = 0):
    """The flagship forward on `device` (None = the card; raises without
    one), with seeded random weights made in the flax layout and carried in
    by convert.py.

    Returns (forward, objective): forward(img1, img2) -> (B, img_h, img_w, 1)
    mask, from NHWC reader-resolution frames in [-0.5, 0.5]. In float32 it
    runs with TF32 off (`device.precision_scope`, entered per call).
    """
    obj = AdversarialObjective(cfg, device)
    obj.load_state_dicts(*from_jax_params(*random_jax_params(obj.generator, obj.pwc, seed)))

    @torch.inference_mode()
    def forward(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        with precision_scope(obj.dtype):
            flow = obj.compute_flow(img1, img2)
            image, flow_n = obj.resize_to_working(img1, flow)
            return obj.generate_mask(image, flow_n)

    return forward, obj


def random_images(cfg, seed: int = 0, device="cpu"):
    """Deterministic random [-0.5, 0.5) frame pair at the reader resolution
    (numpy RandomState, as the JAX package makes them)."""
    rs = np.random.RandomState(seed)
    shape = (cfg.batch_size, cfg.reader_height, cfg.reader_width, 3)
    img1 = torch.from_numpy(rs.rand(*shape).astype(np.float32) - 0.5).to(device)
    img2 = torch.from_numpy(rs.rand(*shape).astype(np.float32) - 0.5).to(device)
    return img1, img2


def time_cuda(fn, *args, iters: int = 10, warmup: int = 2, repeats: int = 3) -> float:
    """Milliseconds per call of `fn(*args)` on the current CUDA stream: the
    median over `repeats` windows of the mean of `iters` back-to-back calls,
    each window timed by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn(*args)
    means = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return float(np.median(means))
