"""Mean ms per batch that the evaluation loop waited on the pipeline's iterator (data layer)."""

from bench_port.lib import readers


def read(ctx):
    return readers.span_ms(ctx, "feed")
