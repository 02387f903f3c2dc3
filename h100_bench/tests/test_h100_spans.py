"""The readers of the program's spans: their arithmetic on synthetic spans
and records, the traced window's bounds, and nothing to read where the
program keeps no spans."""

import sys
from types import SimpleNamespace

import pytest

from h100_bench.lookup import module
from h100_bench.metrics import _spans


def span(id, name, t0, t1, parent=None, **counts):
    return SimpleNamespace(id=id, name=name, parent=parent, request=None, t0_ns=t0, t1_ns=t1, counts=counts)


def record(start_s, end_s, lr_px):
    return SimpleNamespace(start=start_s, end=end_s, lr_px=lr_px)


# one request on the host loop (two batches of 8 windows of 264², the second with one padding window), one
# replay of a graph of 16 such windows, one whole 256² image, and a capture's forwards
WIN = 264 * 264
SPANS = [
    span(1, 'tile.request', 1_000, 9_000, path='host_loop', windows=15, padded_windows=1, batch=8),
    span(2, 'tile.plan', 1_100, 1_200, parent=1),
    span(3, 'tile.batch', 1_300, 5_300, parent=1, windows=8, padded=0),
    span(4, 'model.forward', 1_400, 5_200, parent=3, lr_px=8 * WIN),
    span(5, 'tile.batch', 5_300, 8_300, parent=1, windows=7, padded=1),
    span(6, 'model.forward', 5_400, 8_200, parent=5, lr_px=8 * WIN),
    span(7, 'tile.request', 10_000, 12_000, path='graph', windows=15, padded_windows=1, batch=8),
    span(8, 'tile.replay', 10_500, 11_900, parent=7, lr_px=16 * WIN),
    span(9, 'model.forward', 13_000, 14_000, lr_px=256 * 256),
]
RECORDS = [record(0.5e-6, 9.5e-6, 720 * 1280), record(9.8e-6, 12.5e-6, 720 * 1280),
           record(12.8e-6, 14.5e-6, 256 * 256)]


def test_useful_share_is_delivered_over_computed():
    got = _spans.useful_pct(SPANS, RECORDS)
    assert got == pytest.approx(100 * (2 * 720 * 1280 + 256 * 256) / (32 * WIN + 256 * 256))
    # ESRGAN's 720p frame alone: 15 windows and one padding slot of 264²
    assert _spans.useful_pct(SPANS[6:8], RECORDS[1:2]) == pytest.approx(82.6446, abs=1e-4)


def test_a_capture_in_the_window_is_waste():
    capture = [span(20, 'tile.capture', 10_100, 10_400, parent=7), span(21, 'tile.batch', 10_110, 10_390, parent=20),
               span(22, 'model.forward', 10_120, 10_380, parent=21, lr_px=16 * WIN)]
    assert _spans.useful_pct(SPANS[6:8] + capture, RECORDS[1:2]) == pytest.approx(82.6446 / 2, abs=1e-4)


def test_nothing_computed_reads_none():
    assert _spans.useful_pct([s for s in SPANS if s.name == 'tile.plan'], RECORDS) is None


def test_host_loop_ms_per_window_counts_host_loop_batches_only():
    # the host loop's batches: 4,000 + 3,000 ns over 16 windows; the graph's capture batch is left out
    spans = SPANS + [span(30, 'tile.capture', 10_100, 10_400, parent=7),
                     span(31, 'tile.batch', 10_110, 10_390, parent=30, windows=8, padded=0)]
    assert _spans.host_loop_ms_per_window(spans) == pytest.approx(7_000 / 1e6 / 16)
    assert _spans.host_loop_ms_per_window(SPANS[6:]) is None
    assert _spans.host_loop_ms_per_window([SPANS[2]]) is None  # its request fell out of the ring


def test_window_keeps_closed_spans_inside_the_requests():
    outside = [span(40, 'model.forward', 100, 200, lr_px=1), span(41, 'model.forward', 14_000, 15_000, lr_px=1),
               span(42, 'model.forward', 9_000, None, lr_px=1)]
    assert _spans.in_window(SPANS + outside, RECORDS) == SPANS


@pytest.mark.parametrize('name', ['tile_useful_pct', 'tile_useful_pct.swinir_frames', 'tile_useful_pct.photos',
                                  'tile_useful_pct.swinir_photos', 'host_loop_ms_per_window'])
def test_readers_read_none_without_a_trace_or_without_the_program_spans(name, monkeypatch):
    reader = module('metrics', name)
    assert reader.read(SimpleNamespace(trace=None, trace_records=RECORDS)) is None
    monkeypatch.setitem(sys.modules, 'resselt_tpu_torch.tracing', None)  # a program without spans
    assert reader.read(SimpleNamespace(trace=object(), trace_records=RECORDS)) is None


def test_readers_read_the_program_spans(monkeypatch):
    from resselt_tpu_torch import tracing

    monkeypatch.setattr(tracing, 'spans', lambda: SPANS)
    r = SimpleNamespace(trace=object(), trace_records=RECORDS)
    assert module('metrics', 'tile_useful_pct.photos').read(r) == pytest.approx(_spans.useful_pct(SPANS, RECORDS))
    assert module('metrics', 'host_loop_ms_per_window').read(r) == pytest.approx(7_000 / 1e6 / 16)
