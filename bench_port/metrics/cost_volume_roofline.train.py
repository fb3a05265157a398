"""The cost-volume kernel's share of its roofline in training and pretraining (kernels)."""

from bench_port.lib import readers


def read(ctx):
    return readers.roofline(ctx, "cost_volume")
