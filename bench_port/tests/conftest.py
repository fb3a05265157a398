"""Tests of the port's benchmark (bench_port/): run them from the root of
the repository with `python -m pytest bench_port/tests`. Those marked
`cuda` run only where a card is; they skip elsewhere, decided inside each
test."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA CUDA device")
