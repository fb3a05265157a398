"""Mean ms of a recover_step between CUDA events around the call (learner layer)."""

from bench_port.lib import readers


def read(ctx):
    return readers.step_ms(ctx, "recover")
