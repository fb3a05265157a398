"""Kernel launches per sub-step (per step in pretraining) made inside `ud.train.adam` (learner)."""

from bench_port.lib import spans


def read(ctx):
    return spans.launches(ctx["window"], spans.ADAM)
