"""The evaluation step's FLOPs per second as a share of the dtype's dense peak (model step)."""

from bench_port.lib import readers


def read(ctx):
    return readers.mfu(ctx)
