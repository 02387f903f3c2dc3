"""Output megapixels on the host per second: whole requests, from the
window's start to the last completion."""

from ..stats import rate


def read(r):
    return rate([q.out_px / 1e6 for q in r.records], r.window_start, [q.end for q in r.records])
