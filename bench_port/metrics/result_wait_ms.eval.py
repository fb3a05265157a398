"""Host ms per batch in the copy of IoU and MAE to the host, `ud.eval.result_copy` (model step)."""

from bench_port.lib import spans


def read(ctx):
    return spans.host_ms(ctx["window"], spans.RESULT_COPY)
