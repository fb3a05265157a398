"""Runs of each cell at a CPU size, past the harness's look for a card:
a sound run comes out correct, and one with the timed path broken
underneath comes out not correct, for each fault the cell can have; and
the control (the reference in the precision below the cell's, in the
program's place) comes out not correct under the cell's limits."""

import time

import pytest
import torch

from bench_port.lib.harness import judge_stand_in, run_cell

from bench_port_tiny import CELLS, cell

SEED = 2**31 + 17


def run(name: str, seconds: float = 1.0) -> dict:
    torch.manual_seed(0)
    return run_cell(cell(name), SEED, seconds, False, "cpu", time.monotonic(), log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]


def _first_half(t):
    return None if t is None else t[: t.shape[0] // 2]


def plant(monkeypatch, name: str, fault: str) -> None:
    """Break the program's timed path underneath the harness."""
    entry = cell(name).spec["entry"]
    from unsupervised_detection_tpu_torch.eval import evaluator
    from unsupervised_detection_tpu_torch.train import learner, objective, optim, pretrain_pwc

    if fault == "unchanged":                       # a step that returns its state unchanged
        if entry == "train":
            monkeypatch.setattr(learner, "adam_apply", lambda grads, opt, *a, **k: opt)
        else:
            monkeypatch.setattr(optim.OptaxAdam, "step", lambda self, grads, lr=None: None)
    elif fault == "half_batch":                    # half the batch left out, the mean over the rest
        if entry == "eval":
            metrics = evaluator.Evaluator.infer_metrics
            monkeypatch.setattr(evaluator.Evaluator, "infer_metrics",
                                lambda self, *t: metrics(self, *map(_first_half, t)))
        elif entry == "train":
            forward = objective.AdversarialObjective.forward
            monkeypatch.setattr(objective.AdversarialObjective, "forward",
                                lambda self, *t: forward(self, *map(_first_half, t)))
        else:
            loss = pretrain_pwc.pwc_loss
            monkeypatch.setattr(pretrain_pwc, "pwc_loss",
                                lambda net, *t, **k: loss(net, *map(_first_half, t), **k))
    elif fault == "answer":                        # an answer altered where it is produced
        iou_mae = evaluator.eval_iou_mae
        monkeypatch.setattr(evaluator, "eval_iou_mae",
                            lambda m, g: tuple(x * 0.99 for x in iou_mae(m, g)))


# a state exists to leave unchanged in training; answers to alter in evaluation
FAULTS = [(n, f) for n in CELLS
          for f in (("half_batch", "answer") if ".eval" in n else ("unchanged", "half_batch"))]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    plant(monkeypatch, name, fault)
    result = run(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    c = cell(name)
    runner = c.entry().Runner(c, SEED, "cpu", False, lambda m: None)
    runner.setup()
    numbers = runner.control("control")
    correct, checks = judge_stand_in(numbers, c.spec["limits"])
    assert not correct, checks


def test_the_checked_batches_are_drawn_from_every_batch_the_window_ran():
    c = cell("cis_davis.eval_fp32")
    keep, window = c.spec["traffic"]["check_batches"], 400
    kept = []
    for k in range(200):
        runner = c.entry().Runner(c, SEED + k, "cpu", False, lambda m: None)
        final = {}
        for i in range(window):
            slot = runner._slot(i)
            if slot is not None:
                final[slot] = i
        assert sorted(final) == list(range(keep))
        kept += final.values()
    # a reservoir keeps each batch with the same chance: the kept indices'
    # mean lies at the window's middle (standard error ~4 here)
    assert abs(sum(kept) / len(kept) - (window - 1) / 2) < 25


def test_a_sampled_batch_that_never_came_back_counts_as_missing():
    c = cell("cis_davis.eval_fp32")
    runner = c.entry().Runner(c, SEED, "cpu", False, lambda m: None)
    numbers = runner.compare([], [])
    assert numbers["rows_missing"] == c.spec["traffic"]["check_batches"] * c.config["batch_size"]
