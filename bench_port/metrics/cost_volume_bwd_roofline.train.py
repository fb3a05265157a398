"""The cost volume's backward kernel's share of its roofline in pretraining (kernels)."""

from bench_port.lib import readers


def read(ctx):
    return readers.roofline(ctx, "cost_volume_backward")
