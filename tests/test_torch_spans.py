"""The port's named spans (utils/profiling.py::span) on the CPU at tiny
sizes: none entered without a profiler, each one recorded where the
evaluation loop, the feeder, the nets, the learner's sub-steps and the
pretrainer put it, as often as a batch, sub-step or step runs it, never
one inside another, and the results bit-equal with and without a profiler
recording."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity import moving_square_frames, torch_threads
from unsupervised_detection_tpu_torch import Config
from unsupervised_detection_tpu_torch.eval import Evaluator, evaluate_dataset
from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner
from unsupervised_detection_tpu_torch.train.pretrain_pwc import (PWCPretrainer,
                                                                 synthetic_flow_batch)
from unsupervised_detection_tpu_torch.utils import profiling

_threads = torch_threads(2)

B = 2
SIZES = dict(batch_size=B, reader_height=64, reader_width=128, img_height=32, img_width=64,
             pwc_search_range=2)
RAW_HW = (80, 144)
BATCHES = 3
EVAL_SPANS = ("ud.data.device_batch", "ud.model.crop", "ud.model.pwc",
              "ud.model.working_resize", "ud.model.generator", "ud.eval.metrics",
              "ud.eval.result_copy")
TRAIN_SPANS = ("ud.train.augment", "ud.model.pwc", "ud.model.working_resize",
               "ud.model.generator", "ud.model.recover", "ud.train.backward",
               "ud.train.all_reduce", "ud.train.clip", "ud.train.adam")
PRETRAIN_SPANS = ("ud.pretrain.scene", "ud.model.pwc", "ud.train.backward", "ud.train.adam")


def _raw_batches(n):
    """`n` raw-mode batches as `TestPipeline` yields them: uint8 frames at
    RAW_HW, a uint8 mask, two categories."""
    out = []
    for k in range(n):
        img1, img2, gt = moving_square_frames(B, *RAW_HW, seed=k)
        out.append({"img1_raw": ((img1 + 0.5) * 255).astype(np.uint8),
                    "img2_raw": ((img2 + 0.5) * 255).astype(np.uint8),
                    "gt_raw": (gt * 255).astype(np.uint8),
                    "category": ["seq_a", "seq_b"][:B]})
    return out


def _profiled(fn):
    """(fn's result, the `ud.` spans the profiler recorded on the host as
    (name, start, end, thread), in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end, e.thread)
                    for e in prof.events()
                    if e.name.startswith("ud.") and e.device_type.name == "CPU"),
                   key=lambda s: s[1])
    return result, spans


def _counts(spans):
    counts = {}
    for name, *_ in spans:
        counts[name] = counts.get(name, 0) + 1
    return counts


def _assert_flat(spans):
    """No span starts before the one before it ended, and all share a thread."""
    assert len({s[3] for s in spans}) == 1
    for (a, _, a_end, _), (b, b_start, _, _) in zip(spans, spans[1:]):
        assert b_start >= a_end, f"{b} starts inside {a}"


def _evaluator(dtype):
    return Evaluator(Config(**SIZES, compute_dtype=dtype), device="cpu")


def _learner():
    learner = AdversarialLearner(Config(**SIZES), device="cpu")
    return learner, learner.init_state()


def _frames():
    img1, img2, _ = moving_square_frames(B, 64, 128, seed=3)
    return torch.from_numpy(img1), torch.from_numpy(img2)


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("ud.a") is profiling.span("ud.b")
    with profiling.span("ud.a"):
        pass
    # the program's paths that hold spans run through without one
    ev = _evaluator("float32")
    evaluate_dataset(ev.config, ev, verbose=False, batches=_raw_batches(1))
    learner, state = _learner()
    learner.generator_step(state, *_frames())
    trainer = PWCPretrainer(Config(**SIZES), steps=1, device="cpu")
    trainer.step(*synthetic_flow_batch(np.random.RandomState(0), B, 64, 128, device="cpu"))


def test_span_is_a_record_function_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert isinstance(profiling.span("ud.x"), torch.profiler.record_function)
        with profiling.span("ud.x"):
            torch.ones(2).add_(1)
    assert [e.name for e in prof.events() if e.name == "ud.x"] == ["ud.x"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluate_dataset_records_its_spans_once_a_batch(dtype):
    ev = _evaluator(dtype)
    results, spans = _profiled(lambda: evaluate_dataset(ev.config, ev, verbose=False,
                                                        batches=_raw_batches(BATCHES)))
    assert results["frames"] == BATCHES * B
    counts = _counts(spans)
    # one request a batch and the last one, which ends the stream
    assert counts.pop("ud.eval.feed") == BATCHES + 1
    assert counts == {name: BATCHES for name in EVAL_SPANS}
    _assert_flat(spans)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluation_is_bit_equal_under_a_profiler(dtype):
    batches = _raw_batches(2)
    ev = _evaluator(dtype)
    plain = [ev.infer(*ev.device_batch(b)) for b in batches]
    plain_results = evaluate_dataset(ev.config, ev, verbose=False, batches=batches)
    traced, _ = _profiled(lambda: [ev.infer(*ev.device_batch(b)) for b in batches])
    traced_results, _ = _profiled(lambda: evaluate_dataset(ev.config, ev, verbose=False,
                                                           batches=batches))
    for want, got in zip(plain, traced):
        for key in want:
            assert torch.equal(want[key], got[key]), key
    assert traced_results == plain_results


@pytest.mark.parametrize("player", ["generator", "recover"])
def test_a_sub_step_records_its_spans(player):
    learner, state = _learner()
    step = learner.generator_step if player == "generator" else learner.recover_step
    _, spans = _profiled(lambda: step(state, *_frames()))
    counts = _counts(spans)
    assert counts.pop("ud.model.recover") == 3
    assert counts.pop("ud.train.noise_test", 0) == (1 if player == "generator" else 0)
    assert counts == {name: 1 for name in TRAIN_SPANS if name != "ud.model.recover"}
    _assert_flat(spans)


def test_sub_steps_are_bit_equal_under_a_profiler():
    runs = []
    for traced in (False, True):
        learner, state = _learner()

        def cycle():
            losses = []
            for k in range(1, 5):
                fn = learner.select_step(k)
                _, out, _ = fn(state, *_frames())
                losses.append({name: v.clone() for name, v in out.items()})
            return losses

        losses = _profiled(cycle)[0] if traced else cycle()
        params = {f"{net}.{k}": p.detach().clone()
                  for net in ("generator", "recover")
                  for k, p in getattr(state, net).named_parameters()}
        runs.append((losses, params, state.gen_opt.count, state.rec_opt.count))
    (want_l, want_p, *want_n), (got_l, got_p, *got_n) = runs
    assert got_n == want_n == [3, 1]
    for w, g in zip(want_l, got_l):
        assert all(torch.equal(w[k], g[k]) for k in w)
    assert want_p.keys() == got_p.keys()
    assert all(torch.equal(want_p[k], got_p[k]) for k in want_p)


def test_the_pretrainer_records_its_spans_and_is_bit_equal():
    runs = []
    for traced in (False, True):
        trainer = PWCPretrainer(Config(**SIZES), steps=2, device="cpu")
        rng = np.random.RandomState(5)

        def steps():
            out = []
            for _ in range(2):
                img1, img2, flow = synthetic_flow_batch(rng, B, 64, 128, device="cpu")
                loss, epe, _ = trainer.step(img1, img2, flow)
                out.append((img1, img2, flow, loss, epe))
            return out

        if traced:
            out, spans = _profiled(steps)
            assert _counts(spans) == {name: 2 for name in PRETRAIN_SPANS}
            _assert_flat(spans)
        else:
            out = steps()
        runs.append((out, [p.detach().clone() for p in trainer.params]))
    (want, want_p), (got, got_p) = runs
    for w, g in zip(want, got):
        assert all(torch.equal(a, b) for a, b in zip(w, g))
    assert all(torch.equal(a, b) for a, b in zip(want_p, got_p))
