"""resselt_tpu_torch.tracing on the CPU: spans cost nothing while tracing is
off, give the served path's span tree and counts while it is on, and turn
on by themselves under torch.profiler, where each span is a profiler range
of its own name and length."""

import json
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import resselt_tpu_torch as rt
from resselt_tpu_torch import tracing
from resselt_tpu_torch.ops.fused_conv import WEIGHT_GRAD_RANGE, fused_conv3x3_act
from resselt_tpu_torch.parallel.tiling import _plan_tiled
from resselt_tpu_torch.zoo import make_compact, make_esrgan

torch.set_num_threads(2)

# ESRGAN's 720p geometry in the benchmark's frames: tile 256, halo 4, batches of 8 -> 15 windows + 1 padding
H, W, TILE, HALO, BATCH = 720, 1280, 256, 4, 8


@pytest.fixture
def model():
    return rt.load_from_state_dict(make_compact(4, 1, 2), device='cpu')


@pytest.fixture
def traced():
    tracing.clear()
    tracing.enable()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture
def ranges(monkeypatch):
    """Counts the ``torch.profiler.record_function`` ranges opened."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, 'record_function', counting)
    return opened


def _image(h, w):
    return np.random.default_rng(0).random((h, w, 3)).astype(np.float32)


def test_off_records_nothing_and_opens_no_range(model, ranges):
    tracing.disable()
    tracing.clear()
    assert tracing.span('a', n=1) is tracing.span('b')
    img = _image(40, 40)
    for on_device in (False, None):
        rt.upscale_tiled(model, img, tile=16, halo=2, on_device=on_device)
    rt.upscale_tiled(model, _image(12, 12), tile=16, halo=2)
    model(img)
    rt.load_from_state_dict(make_compact(4, 1, 2), device='cpu')
    assert tracing.spans() == [] and ranges == []


@pytest.mark.parametrize('on_device, path', [(False, 'host_loop'), (None, 'graph')])
def test_span_tree_of_a_tiled_call(model, traced, on_device, path):
    img = _image(H, W)
    for call in range(2):
        tracing.clear()
        rt.upscale_tiled(model, img, tile=TILE, halo=HALO, batch_size=BATCH, on_device=on_device)
        spans = tracing.spans()
        by_id = {s.id: s for s in spans}
        (request,) = [s for s in spans if s.name == 'tile.request']
        assert request.parent is None and {s.request for s in spans} == {request.id}
        assert all(s.t0_ns <= s.t1_ns for s in spans)
        grid, batch = _plan_tiled(model, H, W, TILE, HALO, BATCH, torch.float32)
        windows = len(grid.ys) * len(grid.xs)
        assert (windows, batch) == (15, 8)
        assert request.counts == {'h': H, 'w': W, 'path': path, 'windows': 15, 'padded_windows': 1, 'batch': 8}
        (plan,) = [s for s in spans if s.name == 'tile.plan']
        assert plan.parent == request.id
        assert plan.counts == ({} if path == 'host_loop' else {'cache_hit': call == 1})
        batches = [s for s in spans if s.name == 'tile.batch']
        assert [b.parent for b in batches] == [request.id] * 2
        assert [(b.counts['windows'], b.counts['padded']) for b in batches] == [(8, 0), (7, 1)]
        forwards = [s for s in spans if s.name == 'model.forward']
        assert [by_id[f.parent].name for f in forwards] == ['tile.batch'] * 2
        wy, wx = grid.window
        assert sum(f.counts['lr_px'] for f in forwards) == 16 * wy * wx == 16 * 264 * 264
        assert forwards[0].counts == {'arch': 'Compact', 'batch': 8, 'h': 264, 'w': 264, 'lr_px': 8 * 264 * 264}
        prepares = [s for s in spans if s.name == 'model.prepare']
        assert len(prepares) == (1 - call) and all(by_id[p.parent].name == 'model.forward' for p in prepares)


def test_whole_call_and_load_spans(traced):
    m = rt.load_from_state_dict(make_esrgan(4, 1, 2, gc=4), device='cpu')
    rt.upscale_tiled(m, _image(20, 24), tile=16, halo=4)
    names = [(s.name, s.parent is None) for s in tracing.spans()]
    assert names == [('load', True), ('load.detect', False), ('load.build', False), ('tile.request', True),
                     ('tile.plan', False), ('model.forward', False), ('model.prepare', False)]
    load, request = tracing.spans()[0], tracing.spans()[3]
    assert load.counts == {'arch': 'ESRGAN', 'tensors': 40}
    assert request.counts == {'h': 20, 'w': 24, 'path': 'whole', 'windows': 1, 'padded_windows': 0, 'batch': 1}
    assert tracing.spans()[5].counts['lr_px'] == 20 * 24


def test_profiler_turns_tracing_on_and_each_span_is_a_range(model):
    tracing.disable()
    tracing.clear()
    img = _image(40, 56)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rt.upscale_tiled(model, img, tile=16, halo=2, on_device=False)
        rt.upscale_tiled(model, img, tile=16, halo=2)
    spans = tracing.spans()
    tracing.clear()
    assert {s.name for s in spans} == {'tile.request', 'tile.plan', 'tile.batch', 'model.forward', 'model.prepare'}
    names = {s.name for s in spans}
    events = sorted((e for e in prof.events() if e.name in names), key=lambda e: e.time_range.start)
    assert [e.name for e in events] == [s.name for s in spans]
    for e, s in zip(events, spans):
        assert abs(e.time_range.elapsed_us() - (s.t1_ns - s.t0_ns) / 1e3) < 500
    assert len({s.request for s in spans if s.parent is None}) == 2


def test_nesting_is_per_thread(traced):
    inner = []
    with tracing.span('outer') as outer:
        t = threading.Thread(target=lambda: inner.append(tracing.span('other').__enter__()))
        t.start()
        t.join()
        with tracing.span('inner') as child:
            pass
    assert child.parent == outer.id and child.request == outer.id
    assert inner[0].parent is None and inner[0].request == inner[0].id


def test_ring_is_bounded(traced, monkeypatch):
    monkeypatch.setattr(tracing, '_ring', deque(maxlen=3))
    for i in range(5):
        with tracing.span('s', i=i):
            pass
    assert [s.counts['i'] for s in tracing.spans()] == [2, 3, 4]


@pytest.mark.parametrize('profiled', [False, True])
def test_backward_range_only_under_a_profiler(ranges, profiled):
    tracing.disable()
    tracing.clear()
    x = torch.randn(1, 8, 8, 4, requires_grad=True)
    w = torch.randn(4, 4, 3, 3, requires_grad=True)
    with torch.enable_grad():  # another test of the process may have turned grad mode off
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                fused_conv3x3_act(x, w, act='lrelu').sum().backward()
            assert WEIGHT_GRAD_RANGE in {e.name for e in prof.events()}
            assert [s.name for s in tracing.spans()] == [WEIGHT_GRAD_RANGE]
        else:
            fused_conv3x3_act(x, w, act='lrelu').sum().backward()
            assert ranges == [] and tracing.spans() == []
    assert w.grad is not None
    tracing.clear()


def test_cli_trace_covers_loading(tmp_path):
    from PIL import Image

    from resselt_tpu_torch.upscale import main

    ckpt = tmp_path / 'm.pth'
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in make_compact(4, 1, 2).items()}, ckpt)
    (tmp_path / 'in').mkdir()
    for i in range(2):
        Image.fromarray((_image(40, 48) * 255).astype(np.uint8)).save(tmp_path / 'in' / f'{i}.png')
    assert main([str(ckpt), str(tmp_path / 'in'), str(tmp_path / 'out'), '--device', 'cpu', '--tile', '16',
                 '--trace', str(tmp_path / 'trace')]) == 0
    events = json.loads((tmp_path / 'trace' / 'resselt_tpu_torch.trace.json').read_text())['traceEvents']
    names = {e.get('name') for e in events}
    assert {'load', 'load.detect', 'load.build', 'model.prepare', 'tile.request', 'tile.plan', 'tile.batch',
            'model.forward'} <= names
    tracing.clear()
