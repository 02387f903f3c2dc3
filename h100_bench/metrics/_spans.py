"""What the readers of the program's own spans share.  The program
(``resselt_tpu_torch.tracing``) records its spans while a profiler runs,
so in a run with ``--trace 1`` it holds those of the traced window."""

import importlib

COMPUTES = ('model.forward', 'tile.replay')  # the spans whose ``lr_px`` the model computed


def window_spans(r):
    """The program's closed spans that lie inside the traced window's
    requests; None where the program keeps no spans or the window served
    nothing."""
    if r.trace is None or not r.trace_records:
        return None
    try:
        tracing = importlib.import_module('resselt_tpu_torch.tracing')
    except ImportError:
        return None
    return in_window(tracing.spans(), r.trace_records)


def in_window(spans, records) -> list:
    t0 = min(q.start for q in records) * 1e9
    t1 = max(q.end for q in records) * 1e9
    return [s for s in spans if s.t1_ns is not None and t0 <= s.t0_ns and s.t1_ns <= t1]


def useful_pct(spans, records) -> float | None:
    """100 x the low-resolution pixels the ``records`` delivered over the
    ``lr_px`` of the ``spans`` that ran the model; None where none did."""
    computed = sum(s.counts['lr_px'] for s in spans if s.name in COMPUTES)
    if not computed:
        return None
    return 100.0 * sum(q.lr_px for q in records) / computed


def host_loop_ms_per_window(spans) -> float | None:
    """Host ms of the ``tile.batch`` spans whose ``tile.request`` took the
    host loop over the windows they computed, padding included; None where
    no such batch ran."""
    by_id = {s.id: s for s in spans}
    ns = windows = 0
    for s in spans:
        if s.name != 'tile.batch':
            continue
        request = by_id.get(s.parent)
        while request is not None and request.name != 'tile.request':
            request = by_id.get(request.parent)
        if request is None or request.counts.get('path') != 'host_loop':
            continue
        ns += s.t1_ns - s.t0_ns
        windows += s.counts['windows'] + s.counts['padded']
    return ns / 1e6 / windows if windows else None
