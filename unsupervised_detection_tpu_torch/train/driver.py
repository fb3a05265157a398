"""The training loop, counterpart of unsupervised_detection_tpu/train/
driver.py (reference models/adversarial_learner.py:312-448) on one device:
restore (mandatory flow weights, optional recover warm start, resume), the
1:3 recover/generator alternation, console lines every `summary_freq`,
validation IoU at each epoch's end with `model.best` and `model-<epoch>`
saves, and an epoch of ceil(num_samples_train / batch_size) sub-steps.

The JAX driver's TensorBoard scalars, gradient histograms and summary
images are left out (they need the flow colorizer, which the port does not
have yet), and TF1 checkpoints are refused: the port reads its own `.npz`
saves, which tools/export_torch_checkpoint.py writes from JAX ones.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import torch

from ..config import Config
from ..data import TestPipeline, TrainPipeline, get_reader
from ..device import resolve_device
from . import checkpoint as ckpt
from .learner import AdversarialLearner


class StepTimer:
    """Rolling wall-clock throughput of the train loop (counterpart of
    utils/profiling.py::StepTimer)."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size, self.window = batch_size, window
        self._times: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times = (self._times + [now - self._last])[-self.window:]
        self._last = now

    @property
    def frames_per_second(self) -> float:
        if not self._times:
            return float("nan")
        return self.batch_size * len(self._times) / sum(self._times)


def _refuse_tf1(path: str) -> None:
    if os.path.isfile(path + ".index"):
        raise SystemExit(
            f"{path} is a TF1 checkpoint, which the PyTorch port does not read: import it "
            "with the JAX package (train/tf1_import.py) and export that save with "
            "tools/export_torch_checkpoint.py")


def train(config: Config, max_cycles: Optional[int] = None, verbose: bool = True,
          device=None):
    """Run adversarial training on `device` (None = the card; raises without
    one); returns the final `TrainState`.

    Args:
        config: full configuration.
        max_cycles: optional hard cap on alternation cycles (testing hook).
    """
    if not config.flow_ckpt and not config.allow_random_flow:
        # as the reference (adversarial_learner.py:339-343): training against
        # a random flow net silently produces garbage
        raise SystemExit(
            "No checkpoint for the flow network provided (--flow_ckpt). "
            "Pass --allow_random_flow to train against a randomly "
            "initialized PWC net anyway (synthetic/test runs only).")
    for path in (config.flow_ckpt, config.recover_ckpt, config.full_model_ckpt):
        if path:
            _refuse_tf1(path)
    device = resolve_device(device)

    reader = get_reader(config.dataset, config.root_dir,
                        max_temporal_len=config.max_temporal_len,
                        min_temporal_len=config.min_temporal_len,
                        num_threads=config.num_threads)
    raw_hw = (reader.raw_height, reader.raw_width) if reader.raw_height is not None else None
    reader_hw = (config.reader_height, config.reader_width)
    train_pipe = TrainPipeline(
        reader.dataset(config.train_partition), config.batch_size, config.min_temporal_len,
        config.max_temporal_len, reader_hw=reader_hw, raw_hw=raw_hw,
        num_threads=config.num_threads, seed=config.seed)
    val_partition = "val" if config.dataset != "SEGTRACK" else "all"
    val_pipe = TestPipeline(
        reader.dataset(val_partition), config.batch_size, config.test_temporal_shift,
        reader_hw=reader_hw, raw_hw=raw_hw, num_threads=config.num_threads)

    learner = AdversarialLearner(config, device)
    state = learner.init_state()
    if verbose:
        n_params = sum(p.numel() for net in (state.generator, state.recover, state.pwc)
                       for p in net.parameters())
        print("Number of params: {}".format(n_params))

    # --- restore (adversarial_learner.py:339-360) ----------------------------
    if config.flow_ckpt:
        ckpt.restore_params_scope(config.flow_ckpt, state.pwc, "pwc_params")
        if verbose:
            print("Flow net loaded from {}".format(config.flow_ckpt))
    elif verbose:
        print("WARNING: --allow_random_flow set; PWC flow net is randomly initialized")

    if config.resume_train:
        path = None
        if ckpt.checkpoint_exists(config.full_model_ckpt):
            path = config.full_model_ckpt
        elif os.path.isdir(config.checkpoint_dir):
            path = ckpt.latest_checkpoint(config.checkpoint_dir)
        if not path:
            raise SystemExit("Found no checkpoint to resume training!")
        ckpt.restore_checkpoint(path, state)
        if verbose:
            print("Resumed training from model {}".format(path))
    elif ckpt.checkpoint_exists(config.recover_ckpt):
        ckpt.restore_params_scope(config.recover_ckpt, state.recover, "rec_params")
        if verbose:
            print("Recover net loaded from previous ckpt")
    elif verbose:
        print("No recover checkpoint found! Train Recover from Scratch")

    steps_per_epoch = int(math.ceil(config.num_samples_train / config.batch_size))
    sum_iters = config.iters_rec + config.iters_gen
    min_val_iou = -1.0e12
    if verbose:
        print("-------------------------------------")
        print("Training {} Recover and {} Generator".format(config.iters_rec, config.iters_gen))
        print("-------------------------------------")

    train_iter = iter(train_pipe)
    timer = StepTimer(config.batch_size)
    sub_step = 0
    try:
        while True:
            sub_step += 1
            img1, img2 = learner.feeder.images(next(train_iter))
            start_time = time.time()
            state, losses, _ = learner.select_step(sub_step)(state, img1, img2)
            if sub_step % sum_iters == 0:
                state = learner.incr_step(state)
            timer.tick()
            if config.debug_nans:
                bad = [k for k, v in losses.items() if not bool(torch.isfinite(v))]
                if bad:
                    raise FloatingPointError(
                        f"non-finite losses {bad} at sub-step {sub_step}")

            if sub_step % config.summary_freq == 0:
                loss_gen = float(losses["generator"])  # waits for the step
                loss_rec = float(losses["recover"])
                epoch = math.ceil(sub_step / steps_per_epoch)
                epoch_step = sub_step - (epoch - 1) * steps_per_epoch
                if verbose:
                    print("Epoch: [%2d] [%5d/%5d] time: %4.4f/it (%.1f samples/s) "
                          "loss_generator: %4.4f loss_recover %4.4f"
                          % (epoch, epoch_step, steps_per_epoch, time.time() - start_time,
                             timer.frames_per_second, loss_gen, loss_rec))

            if sub_step % steps_per_epoch == 0:
                epoch = sub_step // steps_per_epoch
                val_iou = _run_validation(learner, state, val_pipe)
                val_iou /= val_pipe.num_steps * config.batch_size
                if verbose:
                    print("Epoch [{}] Validation IoU: {}".format(epoch, val_iou))
                if config.checkpoint_dir:
                    if val_iou > min_val_iou:
                        ckpt.save_best(config.checkpoint_dir, state)
                        min_val_iou = val_iou
                    if epoch % config.save_freq == 0:
                        ckpt.save_epoch(config.checkpoint_dir, epoch, state)
                if epoch == config.max_epochs:
                    if verbose:
                        print("-------------------------------")
                        print("Training completed successfully")
                        print("-------------------------------")
                    break

            if max_cycles is not None and sub_step >= max_cycles * sum_iters:
                break
    finally:
        train_iter.close()
    return state


def _run_validation(learner: AdversarialLearner, state, val_pipe: TestPipeline) -> float:
    """Sum of the validation IoU over one pass of the validation stream."""
    total = 0.0
    for batch in val_pipe:
        img1, img2 = learner.feeder.images(batch)
        total += float(learner.val_step(state, img1, img2, learner.feeder.mask(batch)))
    return total
