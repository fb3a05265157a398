"""Build the port's CUDA kernels and load them with ctypes.

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, into an object file; one more call links them into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o build/<name>_<hash>.o csrc/<name>.cu
    nvcc -shared -o build/libudt_kernels_<hash>.so build/*_<hash>.o

The library is built at first use into `unsupervised_detection_tpu_torch/
build/` (listed in .gitignore), named by a hash of the sources and flags so
an edited source rebuilds. `-Xptxas -v` only reports each kernel's
registers, spills and shared memory (kept in `KernelLibrary.log`). Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh udt::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float   # nvcc wall seconds; 0.0 when the library existed
    log: str               # nvcc's output (ptxas resource usage)

    def check(self, err: int, what: str) -> None:
        """Raise if a launcher returned a CUDA error."""
        if err != 0:
            msg = self.lib.udt_error_string(err).decode()
            raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _nvcc() -> str:
    candidates = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] \
        if os.environ.get("CUDA_HOME") else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built with it at first use")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    lib.udt_cost_volume.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.udt_cost_volume.restype = _I
    lib.udt_warp.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.udt_warp.restype = _I
    lib.udt_cost_volume_backward.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib.udt_cost_volume_backward.restype = _I
    lib.udt_warp_backward.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.udt_warp_backward.restype = _I
    lib.udt_dynamic_copy.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.udt_dynamic_copy.restype = _I
    lib.udt_error_string.argtypes = [_I]
    lib.udt_error_string.restype = ctypes.c_char_p


def _start(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every process, then raise if any failed."""
    outs = [proc.communicate()[0] for _, proc in procs]
    for (cmd, proc), out in zip(procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile_and_link(path: str) -> str:
    """One nvcc per source, all at once, then one link into `path`."""
    stem = path[:-len(".so")]
    tag = f"{os.getpid()}.tmp"
    objs = [f"{stem}_{os.path.basename(src)[:-len('.cu')]}.{tag}.o" for src in _sources()]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src] for obj, src in zip(objs, _sources())]
    log = _run([(cmd, _start(cmd)) for cmd in cmds])
    tmp = f"{path}.{tag}"
    link = [_nvcc(), "-shared", "-o", tmp, *objs]
    log += _run([(link, _start(link))])
    os.replace(tmp, path)
    for obj in objs:
        os.remove(obj)
    return log


@functools.lru_cache(maxsize=1)
def library() -> KernelLibrary:
    """The kernel library, built on the first call of the process."""
    path = os.path.join(BUILD_DIR, f"libudt_kernels_{_digest()}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile_and_link(path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    _declare(lib)
    return KernelLibrary(lib, path, seconds, log)


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
