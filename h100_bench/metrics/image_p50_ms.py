"""Median latency of the window's images (the tiled driver's and the CLI
path's span around each call, on the host's clock), in ms."""

from ..stats import percentile


def read(r):
    return percentile([(q.end - q.start) * 1e3 for q in r.records], 50)
