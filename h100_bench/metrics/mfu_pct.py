"""The whole step's share of the card's peak: the model FLOPs of the low
resolution pixels delivered in the traced window (the configuration's
FLOPs per pixel, counted over the reference), over the window's seconds
times the peak rate, in %.  Halos, padding and windows computed twice
count as no work."""

from ..roofline import PEAK_FLOPS


def read(r):
    if r.trace is None:
        return None
    flops = r.flops_per_lr_px * sum(q.lr_px for q in r.trace_records)
    return 100.0 * flops / (r.trace.window_s * PEAK_FLOPS[r.dtype])
