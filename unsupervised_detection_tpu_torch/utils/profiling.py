"""Tracing and timing helpers, counterpart of
unsupervised_detection_tpu/utils/profiling.py: a torch.profiler trace
context, the port's named spans, a completion helper for the device work
behind a tree of tensors, and the train loop's rolling step timer.

`span(name)` marks one piece of host work at a layer boundary as a
`torch.profiler.record_function` range, so that every torch.profiler run
(`trace`, or a profiler of the caller's own) shows it on the same clock as
the card's kernels; without a profiler recording it does nothing. The
spans are recorded on the thread that drives the card, never nest in one
another, and none covers a whole batch, sub-step or step:

  ud.eval.feed            evaluate_dataset's request to its batch iterator
  ud.data.device_batch    Evaluator.device_batch: pinned copies, cast, resize
  ud.model.crop           the evaluation's central crop and ground-truth resize
  ud.model.pwc            PWCNet.forward
  ud.model.working_resize AdversarialObjective.resize_to_working
  ud.model.generator      AdversarialObjective.generate_mask
  ud.model.recover        RecoverNet.forward (three calls a training forward)
  ud.eval.metrics         eval_iou_mae
  ud.eval.result_copy     the per-batch copy of the results to the host
  ud.train.augment        the augmentation's draws and its application
  ud.train.backward       torch.autograd.grad of a player's or PWC's loss
  ud.train.all_reduce     Mesh.sum_data of the gradients and losses
  ud.train.clip           the per-element clip
  ud.train.noise_test     the generator's vanishing-gradient test (a host sync)
  ud.train.adam           adam_apply, OptaxAdam.step
  ud.pretrain.scene       synthetic_flow_batch

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
    available. The port's `ud.*` spans (module docstring) show on the
    host's timeline above the kernels they launched."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A `torch.profiler.record_function(name)` range while a torch.profiler
    records on this thread; else one shared null context, so that no
    `RecordFunction` is entered when nothing records (the check costs a
    fraction of a microsecond, the range several)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
