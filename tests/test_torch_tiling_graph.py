"""The port's one-dispatch tiled path (``upscale_tiled(on_device=True)``,
the default None, ``tiled_program``) against resselt_tpu's one-dispatch
program on the CPU in f32, where the port runs the tiled forward eagerly:
ESRGAN (3 blocks), PLKSR, SwinIR and ATD at small widths within each family
test's TOL (5e-4; the transformers 2e-3), and equal to the port's host
loop (``on_device=False``) within 1e-6, JAX's ``tests/test_parallel.py``
bound.  Also ``unroll``, ``bucket=True`` forwarding ``on_device``, the
program cache's LRU bound of 8 and its key on the TF32 settings, ``mesh``
still refused, and, on the card (marked ``cuda``), the CUDA graph: captured
once and replayed, its kernel nodes (what a replay launches) the kernels
that the host loop launches.

JAX and the families' JAX-side test helpers are imported inside the tests
that compare with them, so that the ``cuda`` tests also run where JAX is
absent:

    python -m pytest tests/test_torch_tiling_graph.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu_torch.zoo import make_compact, make_esrgan, make_plksr


torch.set_num_threads(2)

HOST_TOL = 1e-6


def _family(name: str):
    """(state dict, the family test's TOL, upscale_tiled kwargs, image
    size): small widths, tile 16 at the loader's halo, a grid of six
    windows."""
    if name == 'esrgan':  # halo 4: a 2 x 3 grid, batches of 4 with the last padded
        return make_esrgan(16, 3, 2, gc=8, seed=21), 5e-4, {'tile': 16, 'batch_size': 4}, (40, 46)
    if name == 'plksr':
        return (make_plksr(16, 2, 2, kernel_size=9, split_ratio=0.5, seed=4), 5e-4, {'tile': 16, 'batch_size': 4},
                (40, 46))
    if name == 'swinir':  # halo 8: 32 x 32 windows, one a batch
        from tests.test_torch_swinir import _sd

        return _sd('pixelshuffle', 2, seed=4), 2e-3, {'tile': 16}, (40, 46)
    from tests.test_torch_atd import _sd  # the f32 halo 16: 48 x 48 windows, one a batch

    return _sd('pixelshuffle', 2, seed=4), 2e-3, {'tile': 16}, (64, 80)


def _img(h=40, w=46, seed=5):
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('on_device', [True, None], ids=['on_device', 'default'])
@pytest.mark.parametrize('family', ['esrgan', 'plksr', 'swinir', 'atd'])
def test_one_dispatch_matches_jax_and_the_host_loop(family, on_device):
    import resselt_tpu
    import resselt_tpu.parallel.tiling as jt

    sd, tol, kw, (h, w) = _family(family)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = _img(h, w)
    want = np.asarray(jt.upscale_tiled(jm, img, on_device=True, **kw))
    got = tt.upscale_tiled(tm, img, on_device=on_device, **kw)
    host = tt.upscale_tiled(tm, img, on_device=False, **kw)
    assert got.shape == want.shape == (2 * h, 2 * w, 3)
    assert float(np.abs(got.numpy() - want).max()) < tol
    assert float((got - host).abs().max()) <= HOST_TOL
    assert len(tm.__dict__['_tiled_fn_cache']) == 1


@pytest.fixture(scope='module')
def esrgan():
    sd = _family('esrgan')[0]
    return sd, resselt_tpu_torch.load_from_state_dict(sd, device='cpu')


def test_unroll_leaves_the_output_unchanged(esrgan):
    import resselt_tpu
    import resselt_tpu.parallel.tiling as jt

    sd, tm = esrgan
    img = _img(seed=6)
    one = tt.upscale_tiled(tm, img, tile=16, batch_size=2)
    for unroll in (2, 3):
        assert torch.equal(tt.upscale_tiled(tm, img, tile=16, batch_size=2, unroll=unroll), one)
    want = np.asarray(jt.upscale_tiled(resselt_tpu.load_from_state_dict(sd), img, tile=16, batch_size=2, unroll=2))
    assert float(np.abs(one.numpy() - want).max()) < 5e-4
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match='unroll'):
            tt.upscale_tiled(tm, img, tile=16, unroll=bad)


@pytest.mark.parametrize('on_device', [False, True])
def test_bucket_forwards_on_device(on_device):
    """``bucket=True`` pads to tile multiples and recurses with
    ``on_device`` (and ``unroll``) as JAX does: the host loop builds no
    program, the one-dispatch path one."""
    tm = resselt_tpu_torch.load_from_state_dict(make_esrgan(16, 1, 2, gc=8, seed=22), device='cpu')
    img = _img(37, 45, seed=7)
    out = tt.upscale_tiled(tm, img, tile=16, bucket=True, on_device=on_device, unroll=2)
    assert out.shape == (74, 90, 3)
    assert len(tm.__dict__.get('_tiled_fn_cache', {})) == int(on_device)
    assert torch.equal(out, tt.upscale_tiled(tm, img, tile=16, bucket=True, on_device=not on_device))


def test_tiled_program_matches_upscale_tiled(esrgan):
    """JAX's ``tests/test_parallel.py::test_tiled_program_matches_upscale_tiled``:
    the program is the one ``upscale_tiled`` serves (one cache entry), and
    an image that fits one window gives ``(None, scale)``."""
    _, tm = esrgan
    tm.__dict__.pop('_tiled_fn_cache', None)
    img = _img(seed=8)
    fn, scale = tt.tiled_program(tm, 40, 46, tile=16, halo=4)
    assert scale == tm.metadata.upscale == 2
    direct = tt.upscale_tiled(tm, img, tile=16, halo=4)
    assert torch.equal(fn(torch.from_numpy(img)), direct)
    assert len(tm.__dict__['_tiled_fn_cache']) == 1
    fn_small, scale_small = tt.tiled_program(tm, 20, 20, tile=16, halo=4)
    assert fn_small is None and scale_small == 2


def test_program_cache_holds_at_most_eight(monkeypatch):
    """Nine image sizes through one model: the LRU keeps the last eight
    programs and releases the evicted one (its graph and pool on the card)."""
    released = []
    monkeypatch.setattr(tt.TiledProgram, 'release', lambda self: released.append(self.grid))
    tm = resselt_tpu_torch.load_from_state_dict(make_compact(8, 1, 2, seed=3), device='cpu')
    grids = []
    for i in range(9):
        h, w = 30 + 2 * i, 34
        tt.upscale_tiled(tm, _img(h, w, seed=i), tile=8, halo=4)
        grids.append(tt._plan_tiled(tm, h, w, 8, 4, None, torch.float32)[0])
    cache = tm.__dict__['_tiled_fn_cache']
    assert tt._TILED_FN_CACHE_MAX == 8 and len(cache) == 8
    assert released == grids[:1] and [k[0] for k in cache] == grids[1:]


def test_kernel_switches_key_the_program_cache(monkeypatch):
    """``use_fused_attention(False)`` (the CLI's ``--no-fused-attention``)
    sends every window attention to the plain path, and the program cache
    keys on it: a second program, not the first one's graph."""
    from resselt_tpu_torch.nn import window
    from resselt_tpu_torch.zoo import make_swinir

    calls = []
    real = window.window_mha
    monkeypatch.setattr(window, 'window_mha', lambda *a, **k: calls.append(1) or real(*a, **k))
    tm = resselt_tpu_torch.load_from_state_dict(make_swinir(16, (2,), (2,), 8, upscale=2), device='cpu')
    img = _img()
    on = tt.upscale_tiled(tm, img, tile=16)
    n_on = len(calls)
    try:
        window.use_fused_attention(False)
        off = tt.upscale_tiled(tm, img, tile=16)
    finally:
        window.use_fused_attention(True)
    assert n_on > 0 and len(calls) == n_on
    assert len(tm.__dict__['_tiled_fn_cache']) == 2
    assert float((on - off).abs().max()) < 2e-3


def test_tf32_settings_key_the_program_cache(esrgan):
    """A graph keeps the kernels chosen at its capture, so the cache keys on
    the TF32 settings in effect (cuDNN's switch, the matmul precision), not
    on the ``precision`` string: flipping TF32 between two calls at the
    default precision builds a second program; ``precision='highest'``
    with TF32 already off shares the first."""
    _, tm = esrgan
    tm.__dict__.pop('_tiled_fn_cache', None)
    img = _img(seed=9)
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision('highest')
        tt.upscale_tiled(tm, img, tile=16)
        tt.upscale_tiled(tm, img, tile=16, precision='highest')
        assert len(tm.__dict__['_tiled_fn_cache']) == 1
        torch.backends.cudnn.allow_tf32 = True
        tt.upscale_tiled(tm, img, tile=16)
        assert len(tm.__dict__['_tiled_fn_cache']) == 2
        torch.set_float32_matmul_precision('high')
        tt.upscale_tiled(tm, img, tile=16)
        assert len(tm.__dict__['_tiled_fn_cache']) == 3
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def test_mesh_is_still_refused(esrgan):
    _, tm = esrgan
    with pytest.raises(NotImplementedError):
        tt.upscale_tiled(tm, _img(), tile=16, mesh=object())
    with pytest.raises(NotImplementedError):
        tt.tiled_program(tm, 40, 46, tile=16, mesh=object())


@pytest.mark.cuda
@pytest.mark.parametrize('family', ['esrgan', 'plksr'])
def test_graph_capture_replays_and_counts_on_the_card(family):
    """On the card: the first call warms up, captures and replays; later
    calls only replay (the replay counter).  The wrapper counts the warm-up
    run's launches and the capture's, each the host loop's, and nothing on
    a replay; what a replay launches, the graph's kernel nodes, equals the
    host loop's launches.  The output equals the host loop's
    within 1e-6 (f32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from chip_smoke import graph_kernel_counts
    from resselt_tpu_torch.ops import fused_conv3x3_act, fused_conv_lk

    entry, source = (fused_conv3x3_act, 'conv3x3') if family == 'esrgan' else (fused_conv_lk, 'conv_lk')
    sd = make_esrgan(16, 3, 2, gc=8, seed=21) if family == 'esrgan' else \
        make_plksr(16, 2, 2, kernel_size=9, split_ratio=0.5, seed=4)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        tm = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
        img = torch.from_numpy(_img(72, 90)).cuda()
        entry.launches = 0
        host = tt.upscale_tiled(tm, img, tile=16, on_device=False)
        torch.cuda.synchronize()
        per_image = entry.launches
        assert per_image > 0
        entry.launches = 0
        first = tt.upscale_tiled(tm, img, tile=16, on_device=True)
        (program,) = tm.__dict__['_tiled_fn_cache'].values()
        assert program.graph is not None and program.replays == 1 and entry.launches == 2 * per_image
        entry.launches = 0
        again = tt.upscale_tiled(tm, img, tile=16)
        torch.cuda.synchronize()
        assert program.replays == 2 and entry.launches == 0
        assert graph_kernel_counts(program.graph) == {source: per_image}
        assert float((again - host).abs().max()) <= HOST_TOL and torch.equal(first, again)
        assert again.data_ptr() != program._out.data_ptr()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
