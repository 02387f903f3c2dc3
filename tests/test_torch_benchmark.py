"""The port's calibrated measurements (resselt_tpu_torch.benchmark) against
resselt_tpu.benchmark on the CPU: ``calibrated_per_iter`` returns JAX's
value, issues JAX's runs and reports JAX's progress on the same scripted
``run`` sequences (tests/test_tools.py's deadline cases among them); the
three measurements on a small Compact loaded on the CPU give JAX's scale,
MP/s by the documented formula from the seconds they return, the halo
rule (run the ``tile + 2 * halo`` window, credit the ``tile * scale``
core), a dependency chain of the stated length, and ValueError for an
image that fits one window."""

import time

import numpy as np
import pytest
import torch

import resselt_tpu
from resselt_tpu import benchmark as jb
from resselt_tpu.zoo import make_compact

import resselt_tpu_torch
from resselt_tpu_torch import benchmark as tb


def _scripted(times):
    """``run(n)`` returning ``times(n)``, the ``n`` of every call kept."""
    calls = []

    def run(n):
        calls.append(n)
        return times(n)

    return run, calls


# run(n) -> seconds: latency-bound, a slow config past 4 x min_seconds, a noisy delta, a tiny per-iteration time
_RUNS = {
    'latency': lambda n: 0.05 * n + 0.2,
    'slow': lambda n: 3.0 * n,
    'noisy': lambda n: 0.01 * n + 0.3 + 0.02 * ((n * 7919) % 5),
    'fast': lambda n: 1e-5 * n + 0.15,
    'flat': lambda n: 0.2,
}


@pytest.mark.parametrize('deadline', [None, 1e9, -1.0], ids=['none', 'generous', 'expired'])
@pytest.mark.parametrize('iters,min_seconds', [(2, 0.3), (3, 2.0), (1, 0.05)])
@pytest.mark.parametrize('name', sorted(_RUNS))
def test_calibrated_per_iter_equals_jax(name, iters, min_seconds, deadline):
    out = {}
    for mod in (jb, tb):
        run, calls = _scripted(_RUNS[name])
        stages = []
        dl = None if deadline is None else time.perf_counter() + deadline
        per = mod.calibrated_per_iter(run, iters, min_seconds=min_seconds, deadline=dl,
                                      progress=lambda s, e: stages.append((s, e)))
        out[mod.__name__] = (per, calls, stages)
    assert out['resselt_tpu_torch.benchmark'] == out['resselt_tpu.benchmark']


def test_calibrated_per_iter_deadline_returns_best_estimate():
    """tests/test_tools.py's case: a generous deadline calibrates fully; an
    expired one returns the latency-inflated first-run estimate without a
    second run, progress streamed."""
    run, calls = _scripted(_RUNS['latency'])
    assert abs(tb.calibrated_per_iter(run, 2, min_seconds=0.3, deadline=time.perf_counter() + 1e9) - 0.05) < 1e-9
    calls.clear()
    stages = []
    per = tb.calibrated_per_iter(run, 2, min_seconds=0.3, deadline=time.perf_counter() - 1.0,
                                 progress=lambda s, e: stages.append(s))
    assert calls == [2]
    assert per == (0.05 * 2 + 0.2) / 2
    assert stages == ['run1']


def test_peak_is_the_h100s():
    assert tb.PEAK_TFLOPS == 989.4


def _models():
    sd = make_compact(num_feat=16, num_conv=2, upscale=2)
    return resselt_tpu.load_from_state_dict(sd), resselt_tpu_torch.load_from_state_dict(sd, device='cpu')


class _Spy:
    """Wraps a model's ``_apply_fn``, recording each forward's input shape."""

    def __init__(self, model):
        self.shapes = []
        inner = model._apply_fn

        def apply_fn(cfg, w, x):
            self.shapes.append(tuple(x.shape))
            return inner(cfg, w, x)

        model._apply_fn = apply_fn


@pytest.mark.parametrize('tile,batch,halo', [(16, 2, 0), (16, 1, 8), (24, 2, 4)])
def test_measure_forward(tile, batch, halo):
    jm, tm = _models()
    spy = _Spy(tm)
    mps, sec, scale = tb.measure_forward(tm, tile, batch, iters=2, min_seconds=0.02, halo=halo)
    want_scale = jb.measure_forward(jm, tile, batch, iters=1, min_seconds=0.001, halo=halo)[2]
    assert scale == want_scale == 2
    assert sec > 0 and mps == pytest.approx((tile * scale) ** 2 * batch / 1e6 / sec, rel=1e-12)
    win = tile + 2 * halo
    assert set(spy.shapes) == {(batch, win, win, 3)}
    # the shape probe, the warm run of ``iters``, then the calibration's runs
    assert len(spy.shapes) >= 1 + 2 + 2 + 3


def test_measure_forward_chains_in_dtype():
    _, tm = _models()
    spy = _Spy(tm)
    mps, sec, scale = tb.measure_forward(tm, 16, 1, dtype=torch.bfloat16, iters=1, min_seconds=0.01)
    assert scale == 2 and mps > 0 and sec > 0
    assert len(set(spy.shapes)) == 1


@pytest.mark.parametrize('fn', ['measure_tiled', 'measure_tiled_direct'])
def test_measure_tiled(fn):
    """tests/test_parallel.py's (96, 140) image at tile 32, halo 8; the
    output MP/s from the seconds a frame; a (40, 40) image fits one window
    and raises ValueError in both packages."""
    jm, tm = _models()
    spy = _Spy(tm)
    mps, sec = getattr(tb, fn)(tm, (96, 140), tile=32, halo=8, min_seconds=0.02)
    assert sec > 0 and mps == pytest.approx(96 * 140 * 4 / 1e6 / sec, rel=1e-12)
    assert spy.shapes and all(s[1:] == (48, 48, 3) for s in spy.shapes)
    for mod, model in ((jb, jm), (tb, tm)):
        with pytest.raises(ValueError, match='fits in one tile window'):
            getattr(mod, fn)(model, (40, 40), tile=32, halo=8, min_seconds=0.01)


def test_measure_tiled_leaves_the_program_usable():
    """The program the measurement warmed is the one ``upscale_tiled``
    serves next, unchanged: no inference tensor in its buffers."""
    from resselt_tpu_torch.parallel import upscale_tiled

    _, tm = _models()
    img = np.random.default_rng(0).random((96, 140, 3), dtype=np.float32)
    tb.measure_tiled(tm, (96, 140), tile=32, halo=8, min_seconds=0.01)
    tb.measure_forward(tm, 16, 1, iters=1, min_seconds=0.01)
    got = upscale_tiled(tm, img, tile=32, halo=8)
    want = upscale_tiled(tm, img, tile=32, halo=8, on_device=False)
    assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))
