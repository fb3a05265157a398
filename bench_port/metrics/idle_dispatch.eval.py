"""% of the traced window the card idled with the host in `ud.model.*` or `ud.eval.metrics`."""

from bench_port.lib import spans


def read(ctx):
    return spans.idle_share(ctx["window"], spans.DISPATCH)
