"""Share of the low-resolution pixels the model computed in the traced
window that reached a request's output, in %: the delivered pixels of the
window's requests over the ``lr_px`` of its ``model.forward`` and
``tile.replay`` spans (the program's).  Windows computed twice over their
halo, padding windows of a batch and any capture in the window are waste."""

from ._spans import useful_pct, window_spans


def read(r):
    spans = window_spans(r)
    return None if spans is None else useful_pct(spans, r.trace_records)
