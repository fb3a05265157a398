"""Build one of the repository's native C++ sources, or one of the port's
own (`native/crc32c.cpp` of this package), into a shared library with g++
and load it with ctypes.

    g++ -O3 -fPIC -std=c++17 -Wall -march=native -shared \\
        -o unsupervised_detection_tpu_torch/build/lib<name>_<hash>.so native/<dir>/<file>.cpp

The flags are those of the sources' own Makefiles, so the library computes
what the JAX package's (built there by `make`) computes on the same
machine. The library is named by a hash of the source and the flags, so an
edited source rebuilds, and is written through a temporary file renamed
into place; nothing is written under `native/`. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from ..ops._build import BUILD_DIR, PACKAGE_DIR

NATIVE_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "native")
PORT_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native")


def load_library(source: str, name: str, root: str = NATIVE_DIR) -> ctypes.CDLL:
    """`<root>/<source>` (the repository's `native/`, or PORT_NATIVE_DIR)
    built (once per source and flags) and loaded. Raises RuntimeError when
    the source or g++ is missing or the build fails."""
    src = os.path.join(root, source)
    if not os.path.isfile(src):
        raise RuntimeError(f"native source {src} not found")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + fh.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if not os.path.exists(path):
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: {name} is built from {src} at its first use")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-shared", "-o", tmp, src]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}")
        os.replace(tmp, path)
    return ctypes.CDLL(path)
