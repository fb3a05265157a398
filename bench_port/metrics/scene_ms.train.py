"""Host ms per pretraining step in `ud.pretrain.scene`, `synthetic_flow_batch` (data)."""

from bench_port.lib import spans


def read(ctx):
    return spans.host_ms(ctx["window"], spans.SCENE)
