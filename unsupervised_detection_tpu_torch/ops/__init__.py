"""Tensor operations of the port: resize, flow, metrics, and the CUDA
kernels' wrappers (cost volume and warp, forward and backward)."""
