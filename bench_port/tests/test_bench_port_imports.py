"""Nothing under bench_port/ imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program; a run
without a card fails and prints no result."""

import ast
import os
import subprocess
import sys

import pytest

from bench_port.lib.harness import BENCH_DIR, FORBIDDEN, ROOT, forbidden_modules

PROGRAM = "unsupervised_detection_tpu_torch"


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


def sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["jax", "jax.numpy", "flax.linen", "optax", "jaxlib.xla_client",
                              "unsupervised_detection_tpu", "unsupervised_detection_tpu.ops",
                              PROGRAM, PROGRAM + ".ops", "jaxtyping", "flaxen", "numpy"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "optax",
        "unsupervised_detection_tpu", "unsupervised_detection_tpu.ops"]


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted(sources("reference")), ids=lambda p: os.path.basename(p))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert PROGRAM not in tops and "bench_port" not in tops
    assert tops <= {"__future__", "dataclasses", "functools", "math", "numpy", "torch"}


def test_no_source_reads_the_old_benchmark():
    for path in (p for p in sources() if os.sep + "tests" + os.sep not in p):
        with open(path) as f:
            text = f.read()
        for old in ("BENCH_r0", "MULTICHIP_r0", "BASELINE.json", "tools/bench_", "bench.py"):
            assert old not in text, (path, old)


def test_the_program_and_the_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import bench_port.reference.model, bench_port.lib.harness, "
            "unsupervised_detection_tpu_torch.eval, unsupervised_detection_tpu_torch.train.learner, "
            "unsupervised_detection_tpu_torch.train.pretrain_pwc; "
            "from bench_port.lib.harness import forbidden_modules; "
            "print(forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          "cis_davis.eval_bf16", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
