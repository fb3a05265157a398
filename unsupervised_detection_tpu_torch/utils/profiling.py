"""Tracing and timing helpers, counterpart of
unsupervised_detection_tpu/utils/profiling.py: a torch.profiler trace
context, a completion helper for the device work behind a tree of tensors,
and the train loop's rolling step timer.

The JAX module's `enable_compilation_cache` has no counterpart here: the
port compiles its kernels once per source digest and keeps the library
(ops/_build.py).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the work inside the scope into `logdir` as a Chrome trace
    (`*.pt.trace.json`), which TensorBoard's profiler plugin and Perfetto
    open: CPU activity always, and the card's kernels where CUDA is
    available."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def _first_tensor(tree) -> Optional[torch.Tensor]:
    """The first tensor leaf of nested dicts (in sorted key order, as
    `jax.tree.leaves` takes them), lists and tuples; None if there is none."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for item in tree:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def sync(tree) -> None:
    """Wait until the device work that produced the first tensor leaf of
    `tree` has finished. Where JAX fetches a scalar of the leaf, this
    synchronizes the current stream of the leaf's CUDA device (the stream
    the port's ops and kernels are queued on), which waits for every
    kernel queued before it. A CPU leaf, or no leaf, needs no wait."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.current_stream(leaf.device).synchronize()


class StepTimer:
    """Rolling wall-clock/throughput tracker for the train loop."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def seconds_per_step(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    @property
    def frames_per_second(self) -> float:
        s = self.seconds_per_step
        return self.batch_size / s if s == s and s > 0 else float("nan")
