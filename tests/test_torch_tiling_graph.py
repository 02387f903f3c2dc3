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
that the host loop launches, for every CUDA source and cuFFT under
capture; and the graphs of one model sharing one memory pool.

JAX and the families' JAX-side test helpers are imported inside the tests
that compare with them, so that the ``cuda`` tests also run where JAX is
absent:

    python -m pytest tests/test_torch_tiling_graph.py -q -m cuda --noconftest
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu_torch.ops import fused_conv3x3_act, fused_conv_lk, fused_molrcm, row_gather, window_mha
from resselt_tpu_torch.zoo import (make_atd, make_compact, make_eimn, make_esrgan, make_lawfft, make_plksr, make_rha,
                                   make_swinir)


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
    """A mesh that is not a ``DeviceMesh`` raises TypeError on both entry
    points; a one-rank gloo mesh gives the meshless output on the host loop,
    the one-dispatch path and ``tiled_program``, from a program of its own
    in the cache (the key holds the mesh)."""
    import torch_mesh_ranks as ranks
    from resselt_tpu_torch.parallel import make_mesh

    _, tm = esrgan
    with pytest.raises(TypeError):
        tt.upscale_tiled(tm, _img(), tile=16, mesh=object())
    with pytest.raises(TypeError):
        tt.tiled_program(tm, 40, 46, tile=16, mesh=object())
    want = tt.upscale_tiled(tm, _img(), tile=16, on_device=False)
    with ranks.one_rank():
        mesh = make_mesh(device='cpu')
        for on_device in (False, True):
            assert torch.equal(tt.upscale_tiled(tm, _img(), tile=16, mesh=mesh, on_device=on_device), want)
        n = len(tm.__dict__['_tiled_fn_cache'])
        fn, scale = tt.tiled_program(tm, 40, 46, tile=16, mesh=mesh)
        assert scale == 2 and torch.equal(fn(torch.from_numpy(_img())), want)
        assert len(tm.__dict__['_tiled_fn_cache']) == n and fn.mesh is mesh


def test_a_mesh_of_a_new_world_gets_its_own_program(esrgan):
    """A world ended and started anew reuses its group names, so a new mesh
    of the old one's layout is not the old one: ``tiled_program`` gives it
    a program of its own, which gathers over the new mesh's group."""
    import torch_mesh_ranks as ranks
    from resselt_tpu_torch.parallel import make_mesh

    _, tm = esrgan
    want = tt.upscale_tiled(tm, _img(), tile=16, on_device=False)
    with ranks.one_rank():
        old, _ = tt.tiled_program(tm, 40, 46, tile=16, mesh=make_mesh(device='cpu'))
        assert torch.equal(old(torch.from_numpy(_img())), want)
    with ranks.one_rank():
        mesh = make_mesh(device='cpu')
        fn, _ = tt.tiled_program(tm, 40, 46, tile=16, mesh=mesh)
        assert fn is not old and fn.mesh is mesh
        assert torch.equal(fn(torch.from_numpy(_img())), want)


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'resselt_tpu_torch', 'csrc')
_GLOBAL = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(')


def kernel_patterns() -> list:
    """(pattern, source stem) for every ``__global__`` function of
    resselt_tpu_torch/csrc/*.cu: a kernel is known by its symbol, mangled
    (``<length>name``) or demangled."""
    out = []
    for name in sorted(os.listdir(CSRC)):
        if name.endswith('.cu'):
            with open(os.path.join(CSRC, name)) as fh:
                out += [(re.compile(rf'{len(s)}{s}|(?<![\w]){s}(?=[<(]|$)'), name[:-3])
                        for s in sorted(set(_GLOBAL.findall(fh.read())))]
    return out


def graph_kernel_counts(graph) -> dict:
    """The kernels of csrc/ among a captured CUDA graph's kernel nodes, by
    source stem: a replay launches each node once, so these are what a
    replay launches, which no Python counter sees.  Read from the graph's
    ``cudaGraph_t`` (``TiledProgram`` captures with ``keep_graph=True``)
    through the driver API: ``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams`` and ``cuFuncGetName`` (or
    ``cuKernelGetName`` for a node that names a library kernel), each name
    matched against :func:`kernel_patterns`."""

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [('func', ctypes.c_void_p), ('grid', ctypes.c_uint * 3), ('block', ctypes.c_uint * 3),
                    ('shared_mem_bytes', ctypes.c_uint), ('kernel_params', ctypes.c_void_p),
                    ('extra', ctypes.c_void_p), ('kern', ctypes.c_void_p), ('ctx', ctypes.c_void_p)]

    cu = ctypes.CDLL('libcuda.so.1')

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f'{what} failed: CUresult {rc}')

    graph_t = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph_t, None, ctypes.byref(n)), 'cuGraphGetNodes')
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph_t, nodes, ctypes.byref(n)), 'cuGraphGetNodes')
    patterns = kernel_patterns()
    counts: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), 'cuGraphNodeGetType')
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              'cuGraphKernelNodeGetParams')
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)), 'cuFuncGetName')
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)), 'cuKernelGetName')
        text = name.value.decode()
        for pat, src in patterns:
            if pat.search(text):
                counts[src] = counts.get(src, 0) + 1
                break
    return counts


# a small model of each family whose forward runs a CUDA source (LAWFFT: cuFFT too), and the wrappers that count
# each source's launches
_GRAPH_FAMILIES = {
    'esrgan': (lambda: make_esrgan(16, 3, 2, gc=8, seed=21), {'conv3x3': fused_conv3x3_act}),
    'plksr': (lambda: make_plksr(16, 2, 2, kernel_size=9, split_ratio=0.5, seed=4), {'conv_lk': fused_conv_lk}),
    'swinir': (lambda: make_swinir(16, (2,), (2,), 8, upscale=2, seed=4), {'window_attn': window_mha}),
    'eimn': (lambda: make_eimn(64, 1, 1, 2.66, 2, seed=4), {'molrcm': fused_molrcm}),
    'atd': (lambda: make_atd(24, (2,), (3,), 8, upscale=2, seed=4), {'window_attn': window_mha,
                                                                     'row_gather': row_gather}),
    'lawfft': (lambda: make_lawfft(16, 1, 2, 2, seed=4), {'conv3x3': fused_conv3x3_act}),
}


@pytest.mark.cuda
@pytest.mark.parametrize('family', sorted(_GRAPH_FAMILIES))
def test_graph_capture_replays_and_counts_on_the_card(family):
    """On the card: the first call warms up, captures and replays; later
    calls only replay (the replay counter).  The wrappers count the warm-up
    run's launches and the capture's, each the host loop's, and nothing on
    a replay; what a replay launches, the graph's kernel nodes, equals the
    host loop's launches of each source.  The output equals the host loop's
    within 1e-6 (f32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    make, entries = _GRAPH_FAMILIES[family]

    def launches():
        torch.cuda.synchronize()
        return {source: entry.launches for source, entry in entries.items()}

    def since(before):
        return {source: n - before[source] for source, n in launches().items()}

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tm = resselt_tpu_torch.load_from_state_dict(make(), device='cuda')
        img = torch.from_numpy(_img(72, 90)).cuda()
        before = launches()
        host = tt.upscale_tiled(tm, img, tile=16, on_device=False)
        per_image = since(before)
        assert all(per_image.values())
        before = launches()
        first = tt.upscale_tiled(tm, img, tile=16, on_device=True)
        (program,) = tm.__dict__['_tiled_fn_cache'].values()
        assert program.graph is not None and program.replays == 1
        assert since(before) == {source: 2 * n for source, n in per_image.items()}
        before = launches()
        again = tt.upscale_tiled(tm, img, tile=16)
        assert program.replays == 2 and not any(since(before).values())
        assert graph_kernel_counts(program.graph) == per_image
        assert float((again - host).abs().max()) <= HOST_TOL and torch.equal(first, again)
        assert again.data_ptr() != program._out.data_ptr()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# distinct 720p-class image sizes, each its own grid, a few windows apart
POOL_SIZES = ((720, 1280), (768, 1152), (800, 1216), (864, 1088))
POOL_GROWTH = 1.5  # x the first size's: one pool a model holds the largest capture's intermediates once


@pytest.mark.cuda
def test_graphs_of_one_model_share_one_pool_on_the_card():
    """RHA 4x at the zoo's widths (dim 64, four groups of six blocks), bf16
    at the loader's hints, through four distinct 720p-class sizes: the
    programs of a model share one graph pool, so a new size adds its static
    canvases, not a replay's intermediates, and the device memory the four
    cached programs keep is at most POOL_GROWTH x what the first keeps."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    model = resselt_tpu_torch.load_from_state_dict(make_rha(64, 4, down_list=(8, 4, 2, 1), res_blocks=6, seed=0),
                                                   device='cuda')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    kept = []
    try:
        for i, (h, w) in enumerate(POOL_SIZES):
            tt.upscale_tiled(model, _img(h, w, seed=10 + i), dtype=torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            kept.append(torch.cuda.memory_reserved() - base)
        assert len(model.__dict__['_tiled_fn_cache']) == len(POOL_SIZES)
        assert 0 < kept[-1] <= POOL_GROWTH * kept[0], kept
    finally:
        for p in model.__dict__.get('_tiled_fn_cache', {}).values():
            p.release()
