"""The share of the traced evaluation window in which the card was idle (device)."""

from bench_port.lib import readers


def read(ctx):
    return readers.idle_share(ctx)
