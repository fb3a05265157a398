"""% of the traced window the card idled while the host was in `ud.pretrain.scene` (device)."""

from bench_port.lib import spans


def read(ctx):
    return spans.idle_share(ctx["window"], spans.SCENE)
