"""The cost-volume kernel's share of its roofline in evaluation (kernels)."""

from bench_port.lib import readers


def read(ctx):
    return readers.roofline(ctx, "cost_volume")
