"""Host ms per sub-step in the generator's noise test, `ud.train.noise_test` (learner)."""

from bench_port.lib import spans


def read(ctx):
    return spans.host_ms(ctx["window"], spans.NOISE_TEST)
