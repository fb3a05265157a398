"""The readers of the program's spans (lib/spans.py and the metrics that
use it) on windows whose spans, device operations and launch records are
known, and the span names they read against those a CPU-profiled tiny run
of the program records."""

import os

import numpy as np
import pytest
import torch

from bench_port.lib import readers, spans, trace
from bench_port.lib.harness import BENCH_DIR, load_module

H = trace.HostEvent


def read(metric: str, window: trace.Window):
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    return load_module(path, "test_reader_" + metric.replace(".", "_")).read({"window": window})


def eval_window() -> trace.Window:
    """Two batches in 1000 us: the card busy over 50..150, 250..450 and
    700..950, so idle over 0..50, 150..250, 450..700 and 950..1000."""
    host = [H("bench.evaluate_dataset", 0, 1000),
            H("ud.eval.feed", 0, 10), H("ud.data.device_batch", 10, 110),
            H("aten::pin_memory", 20, 60), H("cudaLaunchKernel", 70, 71),
            H("ud.model.crop", 110, 120), H("ud.model.pwc", 120, 300),
            H("ud.model.working_resize", 300, 310), H("ud.model.generator", 310, 400),
            H("ud.eval.metrics", 400, 420), H("ud.eval.result_copy", 420, 500),
            H("ud.data.device_batch", 500, 600), H("ud.model.pwc", 600, 800),
            H("ud.eval.result_copy", 800, 1000)]
    device = [("k", 50, 150), ("k", 250, 450), ("k", 700, 950)]
    return trace.Window(0, 1000, device, host, steps=2)


def train_window() -> trace.Window:
    """Four sub-steps in 2000 us: Adam's spans with 3, 1, 1 and 0 launch
    records inside them, one before and one after; three noise tests."""
    host = [H("ud.train.adam", 100, 150), H("ud.train.adam", 600, 700),
            H("ud.train.adam", 1100, 1150), H("ud.train.adam", 1600, 1650),
            H("cudaLaunchKernel", 110, 111), H("cudaLaunchKernel", 120, 121),
            H("cudaLaunchKernelExC", 130, 131), H("cuLaunchKernelEx", 610, 611),
            H("cudaLaunchKernel", 1120, 1121), H("cudaLaunchKernel", 50, 51),
            H("cudaLaunchKernel", 160, 161), H("aten::mul", 1610, 1620),
            H("ud.train.noise_test", 200, 260), H("ud.train.noise_test", 700, 760),
            H("ud.train.noise_test", 1200, 1260)]
    return trace.Window(0, 2000, [("k", 0, 2000)], host, steps=4)


def pretrain_window() -> trace.Window:
    """Two steps in 2000 us, each starting with its scene; the card idle
    over 0..200 and 1000..1250."""
    host = [H("ud.pretrain.scene", 0, 300), H("ud.pretrain.scene", 1000, 1300),
            H("ud.model.pwc", 300, 500), H("ud.train.adam", 900, 950)]
    return trace.Window(0, 2000, [("k", 200, 1000), ("k", 1250, 2000)], host, steps=2)


@pytest.mark.parametrize("metric, window, value", [
    ("feeder_ms.eval", eval_window, 0.1),               # (100 + 100) us over 2 batches
    ("dispatch_ms.eval", eval_window, 0.255),           # 10 + 180 + 10 + 90 + 20 + 200
    ("result_wait_ms.eval", eval_window, 0.14),         # 80 + 200
    ("idle_feeder.eval", eval_window, 14.0),            # 10..50 and 500..600 of 1000
    ("idle_dispatch.eval", eval_window, 20.0),          # 150..250 and 600..700
    ("adam_ms.train", train_window, 0.0625),            # 50 + 100 + 50 + 50 over 4
    ("adam_launches.train", train_window, 1.25),        # 3 + 1 + 1 + 0
    ("host_wait_ms.train", train_window, 0.045),        # 3 x 60 over 4 sub-steps
    ("adam_ms.train", pretrain_window, 0.025),
    ("scene_ms.train", pretrain_window, 0.3),
    ("idle_scene.train", pretrain_window, 22.5),        # 0..200 and 1000..1250 of 2000
])
def test_each_metric_reads_its_spans(metric, window, value):
    assert read(metric, window()) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("metric", [
    "feeder_ms.eval", "dispatch_ms.eval", "result_wait_ms.eval", "idle_feeder.eval",
    "idle_dispatch.eval", "adam_ms.train", "adam_launches.train", "host_wait_ms.train",
    "scene_ms.train", "idle_scene.train"])
def test_a_window_without_the_span_reads_none(metric):
    # the harness's spans, operators and launches, as a program without spans leaves them
    host = [H("bench.evaluate_dataset", 0, 100), H("bench.generator_step", 0, 50),
            H("bench.scene", 50, 100), H("aten::conv2d", 10, 20),
            H("cudaLaunchKernel", 12, 13)]
    w = trace.Window(0, 100, [("k", 20, 40)], host, steps=1)
    assert read(metric, w) is None


def test_launches_need_launch_records():
    w = trace.Window(0, 100, [("k", 0, 50)], [H("ud.train.adam", 10, 20)], steps=1)
    assert spans.launches(w, spans.ADAM) is None
    assert spans.host_ms(w, spans.ADAM) == pytest.approx(0.01)


def test_idle_overlap_counts_once_across_span_edges():
    # one gap, 0..100, under two overlapping spans and one that leaves the gap
    host = [H("ud.model.pwc", 20, 60), H("ud.model.generator", 40, 80),
            H("ud.eval.metrics", 90, 150), H("ud.data.device_batch", 150, 200)]
    w = trace.Window(0, 200, [("k", 100, 180)], host, steps=1)
    assert spans.idle_share(w, spans.DISPATCH) == pytest.approx(100.0 * 70 / 200)
    assert spans.idle_share(w, spans.FEEDER) == pytest.approx(100.0 * 20 / 200)
    assert spans.host_ms(w, spans.DISPATCH) == pytest.approx(0.12)      # 20..80, 90..150
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 10)], [(10, 20)]) == 0


def test_spans_are_cut_to_the_window():
    host = [H("ud.pretrain.scene", -50, 50), H("ud.pretrain.scene", 950, 1050)]
    w = trace.Window(0, 1000, [("k", 50, 950)], host, steps=1)
    assert spans.host_ms(w, spans.SCENE) == pytest.approx(0.1)
    assert spans.idle_share(w, spans.SCENE) == pytest.approx(10.0)


def test_the_idle_metrics_lie_inside_the_idle_share():
    w = eval_window()
    total = readers.idle_share({"window": w})
    assert total == pytest.approx(45.0)
    assert read("idle_feeder.eval", w) + read("idle_dispatch.eval", w) <= total


def test_the_program_records_every_span_the_readers_read():
    from torch.profiler import ProfilerActivity, profile

    from unsupervised_detection_tpu_torch import Config
    from unsupervised_detection_tpu_torch.eval import Evaluator, evaluate_dataset
    from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner
    from unsupervised_detection_tpu_torch.train.pretrain_pwc import (PWCPretrainer,
                                                                     synthetic_flow_batch)

    sizes = dict(batch_size=2, reader_height=64, reader_width=128, img_height=32,
                 img_width=64, pwc_search_range=2)
    rs = np.random.RandomState(0)
    batch = {"img1_raw": rs.randint(0, 256, (2, 80, 144, 3), dtype=np.uint8),
             "img2_raw": rs.randint(0, 256, (2, 80, 144, 3), dtype=np.uint8),
             "gt_raw": (rs.rand(2, 80, 144, 1) > 0.7).astype(np.uint8) * 255,
             "category": ["a", "b"]}
    img1 = torch.from_numpy(rs.rand(2, 64, 128, 3).astype(np.float32) - 0.5)
    img2 = torch.roll(img1, 2, dims=2)
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    try:
        ev = Evaluator(Config(**sizes), device="cpu")
        learner = AdversarialLearner(Config(**sizes), device="cpu")
        state = learner.init_state()
        trainer = PWCPretrainer(Config(**sizes), steps=1, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            evaluate_dataset(ev.config, ev, verbose=False, batches=[batch])
            learner.generator_step(state, img1, img2)
            trainer.step(*synthetic_flow_batch(rs, 2, 64, 128, device="cpu"))
    finally:
        torch.set_num_threads(saved)
    recorded = {e.name for e in prof.events() if e.name.startswith("ud.")}
    groups = (spans.FEEDER, spans.DISPATCH, spans.RESULT_COPY, spans.ADAM, spans.NOISE_TEST,
              spans.SCENE)
    for name in (n for g in groups for n in g):
        assert any(spans.matches(r, (name,)) for r in recorded), name
        if not name.endswith("."):
            assert name in recorded, name
