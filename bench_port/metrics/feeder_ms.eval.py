"""Host ms per batch in the feeder's span, `ud.data.device_batch` (data)."""

from bench_port.lib import spans


def read(ctx):
    return spans.host_ms(ctx["window"], spans.FEEDER)
