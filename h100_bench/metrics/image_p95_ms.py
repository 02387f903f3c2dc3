"""95th percentile of the latency of every image of the window, from its
submission to its pixels on the host, in ms."""

from ..stats import percentile


def read(r):
    return percentile([(q.end - q.start) * 1e3 for q in r.records], 95)
