"""The frozen byte and FLOP formulas against the bounds PERF.md's table of
kernels lists (per forward at batch 8, r=4, backward per pretraining step
at batch 16, both at the reader's 384x640; ms over 3.35 TB/s), and the
statistics behind the end-to-end and per-layer metrics."""

import math

import pytest

from bench_port.lib import bounds, stats, trace


@pytest.mark.parametrize("kernel, batch, dtype, ms", [
    ("cost_volume", 8, "float32", 0.0325), ("cost_volume", 8, "bfloat16", 0.0162),
    ("warp", 8, "float32", 0.0168), ("warp", 8, "bfloat16", 0.0084),
    ("cost_volume_backward", 16, "float32", 0.130), ("cost_volume_backward", 16, "bfloat16", 0.065),
    ("warp_backward", 16, "float32", 0.0509), ("warp_backward", 16, "bfloat16", 0.0254)])
def test_least_times_match_the_kernel_table(kernel, batch, dtype, ms):
    args = (batch, 384, 640, 6, 2, 4, dtype)
    work = {**bounds.pwc_forward_work(*args), **bounds.pwc_backward_work(*args)}[kernel]
    calls, _, _, least_s, bound = work
    assert calls == (5 if kernel.startswith("cost") else 4)
    assert bound == "bytes"
    assert least_s * 1e3 == pytest.approx(ms, rel=0.01)


def test_cost_volume_counts_by_hand():
    # level 2 at batch 1: 96x160 pixels, 32 channels, 81 displacements
    nbytes, ops = bounds.cost_volume(1, 96, 160, 32, 4, 4)
    assert nbytes == (2 * 96 * 160 * 32 + 96 * 160 * 81) * 4
    assert ops == 2.0 * 96 * 160 * 32 * 81
    t, kind = bounds.bound_s(nbytes, ops, "float32")
    assert kind == "bytes" and t == pytest.approx(nbytes / 3.35e12)


def test_levels_follow_the_pyramid():
    assert bounds.pwc_levels(384, 640, 6, 2) == [
        (6, 6, 10, 196), (5, 12, 20, 128), (4, 24, 40, 96), (3, 48, 80, 64), (2, 96, 160, 32)]


def test_union_counts_overlap_once():
    assert trace.union([(0, 2), (1, 3), (5, 6), (6, 7), (8, 8)]) == [(0, 3), (5, 7)]
    assert trace.covered([(0, 2), (1, 3), (5, 7)]) == 5
    assert trace.covered([(0, 10), (2, 3), (4, 5)]) == 10
    assert trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert trace.gaps([(-1, 7)], 0, 6) == []


def test_window_busy_idle_and_labels():
    host = [trace.HostEvent("bench.step", 0, 100), trace.HostEvent("aten::conv2d", 10, 30),
            trace.HostEvent("cudaLaunchKernel", 12, 13), trace.HostEvent("bench.feed", 60, 90),
            trace.HostEvent("aten::copy_", 61, 70)]
    device = [("k_cost_volume_kernel", 20, 40), ("k_other", 30, 50), ("memcpy", 80, 95)]
    w = trace.Window(0, 100, device, host, steps=2)
    assert w.window_s == pytest.approx(100e-6)
    assert w.busy_s() == pytest.approx(45e-6)              # 20..50 and 80..95
    assert w.kernel_s("cost_volume_kernel") == pytest.approx(20e-6)
    idle = dict((k, v) for k, v in w.idle_by_host())
    # 0..20 is held by the conv (midpoint 10), 50..80 by the feed's copy (65), 95..100 by the step
    assert idle == pytest.approx({"bench.step/aten::conv2d": 20e-6,
                                  "bench.feed/aten::copy_": 30e-6,
                                  "bench.step/python": 5e-6})
    assert [name for name, _ in w.top_ops()] == ["k_cost_volume_kernel", "k_other", "memcpy"]


@pytest.mark.parametrize("n", [1, 19, 20, 21, 200, 401])
def test_percentile_is_nearest_rank_over_every_value(n):
    values = list(range(1, n + 1))[::-1]
    p95 = stats.percentile(values, 95)
    assert p95 == math.ceil(0.95 * n)
    assert sum(v > p95 for v in values) == n - math.ceil(0.95 * n)
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_a_host_span_on_the_card_is_no_operation():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, a, b, device, annotation=False):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                               device_type=device, is_user_annotation=annotation)

    prof = SimpleNamespace(events=lambda: [
        ev("bench.window", 0, 100, DeviceType.CPU, True),
        ev("bench.window", 0, 100, DeviceType.CUDA, True),       # its shadow on the card
        ev("bench.step", 5, 95, DeviceType.CUDA, True),
        ev("cost_volume_kernel", 10, 30, DeviceType.CUDA),
        ev("aten::conv2d", 5, 8, DeviceType.CPU)])
    w = trace.from_profiler(prof, "bench.window", steps=1)
    assert w.busy_s() == pytest.approx(20e-6)
    assert [name for name, _ in w.top_ops()] == ["cost_volume_kernel"]
