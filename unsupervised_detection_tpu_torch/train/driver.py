"""The training loop, counterpart of unsupervised_detection_tpu/train/
driver.py (reference models/adversarial_learner.py:312-448) on one device:
restore (mandatory flow weights, optional recover warm start, resume), the
1:3 recover/generator alternation, console lines every `summary_freq`,
validation IoU at each epoch's end with `model.best` and `model-<epoch>`
saves, and an epoch of ceil(num_samples_train / batch_size) sub-steps.

With a checkpoint directory and `tensorboardX` installed, TensorBoard
summaries go there as the JAX driver writes them: every `summary_freq`
sub-steps the losses, `samples_per_sec`, a histogram of each applied
gradient of the stepped net (`{MaskNet|FlownetS}/<flax path>/gradients`)
and the learner's six summary images; the validation IoU per epoch. Without
`tensorboardX` the writer is None and nothing is written, as in JAX.

`--flow_ckpt` and `--recover_ckpt` take the port's saves or a TF1 bundle's
prefix (train/tf1_import.py). A TF1 `--recover_ckpt` is restored, where the
JAX driver skips it: its `checkpoint_exists` asks for a directory
(train/driver.py:110-111, train/checkpoint.py:113-114 there).
`--full_model_ckpt` reads the port's training saves only.

On a mesh (parallel/mesh.py; the train CLI under torchrun) every rank runs
the same seeded pipelines and decodes its rows of each batch. Global rank 0
alone prints, restores (and broadcasts what it read to the other ranks),
saves and writes the summaries; the validation IoU is summed over the data
group, so every rank takes the same `model.best` decision.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..convert import flax_paths
from ..data import TestPipeline, TrainPipeline, get_reader
from ..device import resolve_device
from ..parallel.mesh import Mesh
from ..utils.profiling import StepTimer
from . import checkpoint as ckpt
from .learner import AdversarialLearner
from .tf1_import import is_tf_checkpoint


def _writer(logdir: str):
    """A tensorboardX SummaryWriter on `logdir`, or None when tensorboardX
    does not import (as the JAX driver)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


def _write_summaries(writer, learner: AdversarialLearner, state, losses: dict, grads,
                     is_gen: bool, samples_per_sec: float, img1, img2) -> None:
    """The JAX driver's summaries of one sub-step (train/driver.py:158-177
    there), at the shared step: the losses, the throughput, one histogram
    per applied gradient of the stepped net under its flax path, and the
    summary images in HWC."""
    gs = state.step
    for key, value in losses.items():
        writer.add_scalar(key, float(value), gs)
    writer.add_scalar("samples_per_sec", samples_per_sec, gs)
    net, scope = (state.generator, "MaskNet") if is_gen else (state.recover, "FlownetS")
    paths = flax_paths(net)
    for (name, _), grad in zip(net.named_parameters(), grads):
        writer.add_histogram(f"{scope}/{'/'.join(paths[name][1:])}/gradients",
                             grad.float().cpu().numpy(), gs)
    for key, img in learner.summary_images(state, img1, img2).items():
        writer.add_image(key, np.clip(img[0].cpu().numpy() + 0.5, 0.0, 1.0), gs,
                         dataformats="HWC")


def _restore(config: Config, state, mesh: Mesh, verbose: bool) -> None:
    """The reference's restore (adversarial_learner.py:339-360): flow
    weights, then a resume or a recover warm start. Every rank resolves the
    paths; global rank 0 reads the files and broadcasts the state."""
    read = mesh.is_main
    if config.flow_ckpt:
        if read:
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
        if read:
            ckpt.restore_checkpoint(path, state)
        if verbose:
            print("Resumed training from model {}".format(path))
    elif ckpt.checkpoint_exists(config.recover_ckpt) or is_tf_checkpoint(config.recover_ckpt):
        if read:
            ckpt.restore_params_scope(config.recover_ckpt, state.recover, "rec_params")
        if verbose:
            print("Recover net loaded from previous ckpt")
    elif verbose:
        print("No recover checkpoint found! Train Recover from Scratch")
    if mesh.group is not None:
        _broadcast_state(mesh, state)


def _broadcast_state(mesh: Mesh, state) -> None:
    """Global rank 0's weights, Adam states, step and rng on every rank."""
    tensors = [t for net in (state.generator, state.recover, state.pwc)
               for t in net.state_dict().values()]
    for opt in (state.gen_opt, state.rec_opt):
        tensors += [opt.m[k] for k in sorted(opt.m)] + [opt.v[k] for k in sorted(opt.v)]
    counts = torch.tensor([state.step, state.gen_opt.count, state.rec_opt.count])
    rng = state.rng.get_state()
    mesh.broadcast(tensors + [counts, rng])
    state.step, state.gen_opt.count, state.rec_opt.count = (int(c) for c in counts)
    state.rng.set_state(rng)


def train(config: Config, max_cycles: Optional[int] = None, verbose: bool = True,
          device=None, mesh: Optional[Mesh] = None):
    """Run adversarial training on `device` (None = the card; raises without
    one); returns the final `TrainState`.

    Args:
        config: full configuration.
        max_cycles: optional hard cap on alternation cycles (testing hook).
        mesh: this rank's mesh (None: one process); config.batch_size is
            the global batch.
    """
    if not config.flow_ckpt and not config.allow_random_flow:
        # as the reference (adversarial_learner.py:339-343): training against
        # a random flow net silently produces garbage
        raise SystemExit(
            "No checkpoint for the flow network provided (--flow_ckpt). "
            "Pass --allow_random_flow to train against a randomly "
            "initialized PWC net anyway (synthetic/test runs only).")
    if config.resume_train and is_tf_checkpoint(config.full_model_ckpt):
        raise SystemExit(f"--full_model_ckpt={config.full_model_ckpt} is a TF1 bundle: a "
                         "resume reads the port's training saves (the JAX driver does not "
                         "read TF1 there either)")
    device = resolve_device(device)
    mesh = mesh if mesh is not None else Mesh()
    verbose = verbose and mesh.is_main
    rows = mesh.batch_rows(config.batch_size)

    reader = get_reader(config.dataset, config.root_dir,
                        max_temporal_len=config.max_temporal_len,
                        min_temporal_len=config.min_temporal_len,
                        num_threads=config.num_threads)
    raw_hw = (reader.raw_height, reader.raw_width) if reader.raw_height is not None else None
    reader_hw = (config.reader_height, config.reader_width)
    train_pipe = TrainPipeline(
        reader.dataset(config.train_partition), config.batch_size, config.min_temporal_len,
        config.max_temporal_len, reader_hw=reader_hw, raw_hw=raw_hw,
        num_threads=config.num_threads, seed=config.seed, rows=rows)
    val_partition = "val" if config.dataset != "SEGTRACK" else "all"
    val_pipe = TestPipeline(
        reader.dataset(val_partition), config.batch_size, config.test_temporal_shift,
        reader_hw=reader_hw, raw_hw=raw_hw, num_threads=config.num_threads, rows=rows)

    learner = AdversarialLearner(config, device, mesh)
    state = learner.init_state()
    if verbose:
        n_params = sum(p.numel() for net in (state.generator, state.recover, state.pwc)
                       for p in net.parameters())
        print("Number of params: {}".format(n_params))

    _restore(config, state, mesh, verbose)

    steps_per_epoch = int(math.ceil(config.num_samples_train / config.batch_size))
    sum_iters = config.iters_rec + config.iters_gen
    min_val_iou = -1.0e12
    if verbose:
        print("-------------------------------------")
        print("Training {} Recover and {} Generator".format(config.iters_rec, config.iters_gen))
        print("-------------------------------------")

    writer = _writer(config.checkpoint_dir) if config.checkpoint_dir and mesh.is_main else None
    # the summary images' forward needs every rank of data index 0's model
    # group: rank 0 tells them whether it writes
    summaries = torch.tensor([int(writer is not None)])
    mesh.broadcast([summaries])
    summaries = bool(summaries[0])
    train_iter = iter(train_pipe)
    timer = StepTimer(config.batch_size)
    sub_step = 0
    try:
        while True:
            sub_step += 1
            img1, img2 = learner.feeder.images(next(train_iter))
            start_time = time.time()
            step = learner.select_step(sub_step)
            state, losses, grads = step(state, img1, img2)
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
                if writer is not None:
                    _write_summaries(writer, learner, state, losses, grads,
                                     step == learner.generator_step, timer.frames_per_second,
                                     img1, img2)
                elif summaries and mesh.data_index == 0:
                    # the model group's share of rank 0's summary forward
                    learner.summary_images(state, img1, img2)

            if sub_step % steps_per_epoch == 0:
                epoch = sub_step // steps_per_epoch
                val_iou = _run_validation(learner, state, val_pipe)
                val_iou /= val_pipe.num_steps * config.batch_size
                if verbose:
                    print("Epoch [{}] Validation IoU: {}".format(epoch, val_iou))
                if writer is not None:
                    writer.add_scalar("IoU_on_Validation", val_iou, epoch)
                if config.checkpoint_dir:
                    if val_iou > min_val_iou:
                        if mesh.is_main:
                            ckpt.save_best(config.checkpoint_dir, state)
                        min_val_iou = val_iou
                    if epoch % config.save_freq == 0 and mesh.is_main:
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
        if writer is not None:
            writer.close()
    return state


def _run_validation(learner: AdversarialLearner, state, val_pipe: TestPipeline) -> float:
    """Sum of the validation IoU over one pass of the validation stream."""
    total = 0.0
    for batch in val_pipe:
        img1, img2 = learner.feeder.images(batch)
        total += float(learner.val_step(state, img1, img2, learner.feeder.mask(batch)))
    return total
