"""Tensor operations of the port: resize, flow, metrics, and the two CUDA
kernels' wrappers (cost volume, warp)."""
