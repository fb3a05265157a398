"""The port's tracing and timing helpers (utils/profiling.py) on the CPU:
the trace file, `sync` on tensor trees, and the step timer against the
JAX package's on the same clock readings."""

import json
import os

import pytest
import torch

from torch_parity import torch_threads
from unsupervised_detection_tpu.utils import profiling as jprof
from unsupervised_detection_tpu_torch.train import driver
from unsupervised_detection_tpu_torch.utils import profiling as tprof

_threads = torch_threads(1)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)):
        y = torch.mm(x, x).relu().sum()
    tprof.sync(y)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_sync_takes_trees_and_empty_ones():
    t = torch.ones(3)
    for tree in (t, (t, t * 2), {"b": [t], "a": None}, [], {}, None, (1.0, "x")):
        assert tprof.sync(tree) is None
    assert tprof._first_tensor({"b": t, "a": [None, t * 3]}).tolist() == [3.0] * 3
    assert tprof._first_tensor([1, (2, {"k": t})]) is t
    assert tprof._first_tensor({"a": [], "b": ()}) is None


@pytest.mark.parametrize("window", [1, 3, 50])
def test_step_timer_matches_jax(monkeypatch, window):
    ticks = [0.0, 0.5, 0.75, 2.0, 2.125, 2.2, 4.0, 4.001]
    timers = {}
    for name, mod in (("jax", jprof), ("torch", tprof)):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(batch_size=16, window=window)
        readings = [(timer.seconds_per_step, timer.frames_per_second)]
        for _ in ticks:
            timer.tick()
            readings.append((timer.seconds_per_step, timer.frames_per_second))
        timers[name] = (readings, list(timer._times))
    assert repr(timers["torch"]) == repr(timers["jax"])     # nan == nan as text
    assert len(timers["torch"][1]) == min(window, len(ticks) - 1)
    assert driver.StepTimer is tprof.StepTimer
