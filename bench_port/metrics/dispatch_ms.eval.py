"""Host ms per batch in the nets' spans and the metrics' (`ud.model.*`, `ud.eval.metrics`)."""

from bench_port.lib import spans


def read(ctx):
    return spans.host_ms(ctx["window"], spans.DISPATCH)
