"""The benchmark's run: one cell, one seed, one window, one result line.

A run reads `BENCHMARK.json` at the root of the checkout and finds
everything else by name under `bench_port/`: the cell's workload file
`workloads/<cell>.json` (its configuration, traffic, compute dtype, the
entry it drives, the limits of its correctness numbers and, where the
cell sets one, `cuda_alloc_conf` for PyTorch's CUDA allocator), the
configuration's `configs/<config>.json`, the entry `entries/<entry>.py`
and one reader `metrics/<metric>.py` per per-layer metric. A later cell,
configuration, entry or metric is added as new files.

Each run: set-up (weights and inputs from the seed, the cell's shapes
warmed, and with --trace 1 the step's FLOPs counted), the measured window
of --seconds, with --trace 1 a profiled window after it, then the
program's state is freed and the plain reference judges what the timed
path produced. The last line of standard output is one JSON object; the
numbers compared are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import types

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run of the port may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "unsupervised_detection_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name, compared whole, is one that
    the port may not load."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


class Cell:
    """One cell as the manifest and its files describe it."""

    def __init__(self, name: str, manifest: dict | None = None, overrides: dict | None = None):
        self.manifest = manifest if manifest is not None else \
            load_json(os.path.join(ROOT, "BENCHMARK.json"))
        entry = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not entry:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.chips = entry[0]["chips"]
        self.spec = load_json(os.path.join(BENCH_DIR, "workloads", name + ".json"))
        self.config = load_json(os.path.join(BENCH_DIR, "configs", self.spec["config"] + ".json"))
        for key, value in (overrides or {}).items():
            getattr(self, key).update(value)
        self.end_to_end = [m for m in self.manifest["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in self.manifest["per_layer"] if applies(m, name)]

    def entry(self):
        path = os.path.join(BENCH_DIR, "entries", self.spec["entry"] + ".py")
        return load_module(path, "bench_port_entry_" + self.spec["entry"])

    def reader(self, metric: str):
        path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
        return load_module(path, "bench_port_metric_" + metric.replace(".", "_")).read


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the numbers that the cell's
    limits name: each there, finite, and at or under its limit."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        ok = ok and math.isfinite(value) and value <= limit
        checks[name] = {"value": value if math.isfinite(value) else str(value), "limit": limit}
    return ok, checks


def judge_stand_in(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """`judge` of a control or a fault that stands in the program's place,
    over the numbers it reads: the checks of the program's own path, such
    as its kernel launches, have no reading there and fail nothing."""
    return judge(numbers, {k: v for k, v in limits.items() if k in numbers})


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, log=print) -> dict:
    """Set-up, window, optional profiled window, then the check; the
    result object (without the trace's reading when `trace` is off)."""
    import torch

    on_card = device.startswith("cuda")
    if on_card:
        t0 = time.monotonic()
        torch.cuda.init()
        torch.empty(1, device=device)
        log(f"setup: the CUDA context {time.monotonic() - t0:.3f} s")
        torch.cuda.reset_peak_memory_stats()
    log(f"setup: process start to the cell's own set-up {time.monotonic() - t_start:.3f} s")
    runner = cell.entry().Runner(cell, seed, device, trace, log)
    runner.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    window = runner.window(seconds)
    metrics: dict = {}
    breakdown = None
    if trace:
        traced = runner.traced()
        ctx = runner.layer_context(traced)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": traced.top_ops(), "idle_gaps": traced.idle_by_host()}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0,
                   "power_limit": card_line().rsplit(", ", 1)[-1] if on_card else "none"}
    if trace:
        device_info["busy_s"] = traced.busy_s()
        device_info["window_s"] = traced.window_s
    runner.release()
    numbers = runner.check()
    correct, checks = judge(numbers, cell.spec["limits"])
    log("numbers not compared in this cell: " + json.dumps(
        {k: v for k, v in numbers.items() if k not in checks}))
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks       # last: the numbers compared, each beside its limit
    return result


def _process_start() -> float:
    """time.monotonic() at which this process started (the kernel's record
    of its start; now, where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic()
    return time.monotonic() - min(max(age, 0.0), 60.0)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv) -> int:
    t_start = _process_start()
    args = parse(argv)
    cell = Cell(args.workload)
    if "cuda_alloc_conf" in cell.spec:     # read by PyTorch's allocator when CUDA starts
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cell.spec["cuda_alloc_conf"]
    t0 = time.monotonic()
    import torch

    imported = time.monotonic()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    print(f"setup: process start to torch imported {imported - t_start:.3f} s "
          f"(the import {imported - t0:.3f} s)", flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start,
                      log=lambda msg: print(msg, flush=True))
    found = forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {found}", file=sys.stderr)
        return 3
    device = result["device"]
    print(f"bench_port: {cell.name} seed {args.seed} on {device['kind']}, "
          f"{device['power_limit']}", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
