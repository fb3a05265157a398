"""On the card: each cell runs through `bench_port/run.py` as the
benchmark's check runs it, traced and not, and comes out correct with the
contract's keys. Skips where no card is (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from bench_port.lib.harness import ROOT, load_json

CELLS = [w["name"] for w in load_json(ROOT + "/BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_the_card_is_correct(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", cell,
                          "--seed", str(2**31 + 99), "--seconds", "10", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
        assert all(0 < m["value"] <= 105 for k, m in result["metrics"].items()
                   if "roofline" in k or "mfu" in k)
    else:
        assert "setup_s" in result["metrics"]
