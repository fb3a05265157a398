"""BENCHMARK.json and the files it names, held to the benchmark's contract."""

import json
import os
import re

import pytest

from bench_port.lib.harness import BENCH_DIR, ROOT, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
MANIFEST = load_json(os.path.join(ROOT, "BENCHMARK.json"))


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert MANIFEST["paths"] == ["bench_port"]
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(one_line(w) for w in MANIFEST["command"])
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    # a full check of 24 cells fits 43200 s
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (MANIFEST["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    entries = [("configs", c) for c in MANIFEST["configs"]] + \
        [("workloads", w) for w in MANIFEST["workloads"]] + \
        [("end_to_end", m) for m in MANIFEST["end_to_end"]] + \
        [("per_layer", m) for m in MANIFEST["per_layer"]]
    for kind, e in entries:
        assert NAME.match(e["name"]), e["name"]
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert one_line(e[key]), (e["name"], key)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[kind]]
        assert len(names) == len(set(names)), kind
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entries_have_only_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == [] and c["file"].startswith("bench_port/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for cell in cells:
        assert any(cell in on for name, on in e2e.items() if name != "setup_s"), cell
        assert any(cell in m.get("workloads", cells) for m in MANIFEST["per_layer"]), cell
    layers: dict = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]], (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"data", "learner", "model step", "kernels", "device"}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_has_its_files(cell):
    w = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    spec = load_json(os.path.join(BENCH_DIR, "workloads", cell + ".json"))
    assert spec["config"] == w["config"] and spec["chips"] == w["chips"] and spec["why"] == w["why"]
    assert os.path.exists(os.path.join(BENCH_DIR, "entries", spec["entry"] + ".py"))
    config = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert os.path.exists(os.path.join(ROOT, config["file"]))
    assert spec["compute_dtype"] in ("float32", "bfloat16")
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_every_per_layer_metric_has_its_reader(metric):
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    assert os.path.exists(path)
    with open(path) as f:
        assert "def read(ctx)" in f.read()


def test_config_files_hold_the_reference_widths():
    for c in MANIFEST["configs"]:
        cfg = load_json(os.path.join(ROOT, c["file"]))
        assert cfg["pwc_pyramid_widths"] == [16, 32, 64, 96, 128, 196]
        assert cfg["pwc_estimator_widths"] == [128, 128, 96, 64, 32]
        assert (cfg["pwc_pyr_lvls"], cfg["pwc_flow_pred_lvl"], cfg["pwc_search_range"]) == (6, 2, 4)
        assert (cfg["reader_height"], cfg["reader_width"], cfg["batch_size"]) == (384, 640, 16)
        assert (cfg["cnum"], cfg["recover_f"]) == (32, 0.25)


def test_the_files_under_paths_are_named_from_names():
    allowed = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for dirpath, _, files in os.walk(BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert allowed.match(rel) and len(rel) <= 200, rel
    json.dumps(MANIFEST)
