"""PyTorch / CUDA port of the unsupervised moving-object detector for one
NVIDIA H100.

Mirrors the module layout of the JAX package `unsupervised_detection_tpu`
so each module's counterpart is found at the same path. Public functions
keep the JAX layout: NHWC images and flows, flow channel 0 is y. The two
Pallas TPU kernels of the flagship forward (PWC cost volume and backward
warp) are hand-written CUDA kernels under `csrc/`, with CUDA kernels of
their gradients for PWC pretraining, built by `nvcc` at first use
(`ops/_build.py`); every other operation is plain PyTorch. Post-processing
(soft scores, host propagation, the dense CRF) runs on the host in numpy
and cv2, and over the repository's native C++ solvers built with g++ at
first use (`native/`).

Importing this package imports neither JAX nor the JAX package.
"""

from .config import Config, parse_flags

__all__ = ["Config", "parse_flags"]
