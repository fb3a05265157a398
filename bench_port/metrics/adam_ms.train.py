"""Host ms per sub-step (per step in pretraining) in Adam's span, `ud.train.adam` (learner)."""

from bench_port.lib import spans


def read(ctx):
    return spans.host_ms(ctx["window"], spans.ADAM)
