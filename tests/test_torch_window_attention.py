"""resselt_tpu_torch.ops.window_mha and nn/window.py against resselt_tpu.

On the CPU the port's wrapper computes its plain version; it is held
against the JAX Pallas kernel run in interpret mode and against JAX's
``multi_head_attention`` (whose CPU dispatch is ``_mha_xla``), in f32, with
test_pallas_ops.py's tolerance (rtol = atol = 2e-4), at that test's three
shapes and at SwinIR's (n 64, C 180, 6 heads, with and without a shift
mask; n 49, window 7).  The window geometry is held equal to JAX's.  The
CUDA kernel itself is held against the plain version in
test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from resselt_tpu.nn import window as jw
from resselt_tpu.ops.window_attention import window_mha_pallas
from resselt_tpu_torch.nn import window as tw
from resselt_tpu_torch.ops import window_attention as wa


torch.set_num_threads(2)

TOL = 2e-4


def _inputs(n, c, heads, masked, nw=4, b=2, m=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * nw, n, c), np.float32)
    k, v = (rng.standard_normal((b * nw, m or n, c), np.float32) for _ in range(2))
    bias = (rng.standard_normal((heads, n, m or n)) * 0.1).astype(np.float32)
    mask = None
    if masked:
        mask = np.where(rng.random((nw, n, m or n)) < 0.2, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize('n,c,heads,masked', [
    (128, 180, 6, True),    # DAT-S spatial branch (8x16 rect windows)
    (256, 144, 6, False),   # HAT-S window attention (ws=16)
    (256, 48, 4, True),     # ATD-light window branch
    (64, 180, 6, True),     # SwinIR-M shifted block (ws=8)
    (64, 180, 6, False),    # SwinIR-M block
    (49, 60, 6, True),      # window 7, SwinIR-light width
])
def test_window_mha_matches_pallas_and_mha(n, c, heads, masked):
    q, k, v, bias, mask = _inputs(n, c, heads, masked)
    scale = (c // heads) ** -0.5
    pallas = np.asarray(window_mha_pallas(q, k, v, bias, mask, num_heads=heads, scale=scale, interpret=True))
    xla = np.asarray(jw.multi_head_attention(q, k, v, heads, scale, bias=bias, mask=mask))
    got = wa.window_mha(*map(_t, (q, k, v, bias, mask)), num_heads=heads, scale=scale)
    assert got.shape == pallas.shape and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), xla, rtol=TOL, atol=TOL)
    # the port's dispatch takes this shape to the kernel's wrapper
    via = tw.multi_head_attention(*map(_t, (q, k, v)), heads, scale, bias=_t(bias), mask=_t(mask))
    assert torch.equal(via, got)


@pytest.mark.parametrize('case', ['no_bias', 'overlapping_keys'])
def test_plain_path_matches_jax(case):
    """What the kernel does not take (no bias; HAT's M > N keys) goes the
    plain ``_mha_xla`` path, as in JAX."""
    heads, c = 4, 32
    q, k, v, bias, mask = _inputs(16, c, heads, True, m=36 if case == 'overlapping_keys' else None, seed=1)
    if case == 'no_bias':
        bias = None
    want = np.asarray(jw.multi_head_attention(q, k, v, heads, 0.3, bias=bias, mask=mask))
    before = wa.window_mha.launches
    got = tw.multi_head_attention(*map(_t, (q, k, v)), heads, 0.3, bias=_t(bias), mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert wa.window_mha.launches == before


def test_qkv_slices_equal_contiguous_copies():
    """swin_window_attention hands the kernel q, k, v as channel slices of
    one qkv projection."""
    q, k, v, bias, mask = _inputs(64, 60, 6, True, seed=2)
    qkv = torch.cat([_t(q), _t(k), _t(v)], dim=-1)
    sl = (qkv[..., :60], qkv[..., 60:120], qkv[..., 120:])
    assert sl[0].stride() == (64 * 180, 180, 1)
    assert wa._token_strides(*sl) == (64 * 180, 180)
    a = wa.window_mha(*sl, _t(bias), _t(mask), num_heads=6, scale=0.2)
    b = wa.window_mha(*(t.contiguous() for t in sl), _t(bias), _t(mask), num_heads=6, scale=0.2)
    assert torch.equal(a, b)


def test_supported_bounds():
    assert wa.window_mha_supported(1, 8, 1) and wa.window_mha_supported(256, 256, 4)
    assert wa.window_mha_supported(64, 180, 6) and wa.window_mha_supported(49, 60, 6)
    assert not wa.window_mha_supported(0, 8, 1)
    assert not wa.window_mha_supported(257, 180, 6)
    assert not wa.window_mha_supported(64, 260, 4)  # head_dim 65
    assert not wa.window_mha_supported(64, 180, 7)  # C not a multiple of heads
    assert not wa.window_mha_supported(64, 180, 0)


@pytest.mark.parametrize('case', ['n_257', 'head_dim_65', 'bias_shape', 'mask_windows', 'kv_shape'])
def test_rejects_what_it_does_not_take(case):
    n, c, heads = {'n_257': (257, 16, 2), 'head_dim_65': (4, 130, 2)}.get(case, (16, 32, 4))
    q = torch.zeros((6, n, c))
    k = torch.zeros((6, n + 1, c)) if case == 'kv_shape' else q
    bias = torch.zeros((heads, n, n + (case == 'bias_shape')))
    mask = torch.zeros((4, n, n)) if case == 'mask_windows' else None
    with pytest.raises(ValueError):
        wa.window_mha(q, k, q, bias, mask, num_heads=heads, scale=1.0)


def test_bf16_on_cpu_rounds_the_f32_result():
    q, k, v, bias, mask = _inputs(64, 180, 6, True, seed=3)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = wa.window_mha(qb, kb, vb, _t(bias), _t(mask), num_heads=6, scale=30 ** -0.5)
    assert got.dtype == torch.bfloat16
    want = wa.window_mha_ref(qb.float(), kb.float(), vb.float(), _t(bias), _t(mask), num_heads=6, scale=30 ** -0.5)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=0.0)


def test_cpu_calls_do_not_count_launches():
    q, k, v, bias, mask = _inputs(16, 32, 4, True, seed=4)
    before = (wa.window_mha.launches, sum(wa.window_mha.by_shape.values()))
    wa.window_mha(*map(_t, (q, k, v, bias, mask)), num_heads=4, scale=1.0)
    wa.window_mha(torch.zeros((0, 16, 32)), torch.zeros((0, 16, 32)), torch.zeros((0, 16, 32)),
                  torch.zeros((4, 16, 16)), num_heads=4, scale=1.0)
    assert (wa.window_mha.launches, sum(wa.window_mha.by_shape.values())) == before


@pytest.mark.parametrize('ws,shift,h,w', [(8, 4, 32, 40), (7, 3, 28, 21), (8, 0, 16, 16), (16, 8, 32, 64)])
def test_window_geometry_equals_jax(ws, shift, h, w):
    assert np.array_equal(tw.relative_position_index(ws, ws), jw.relative_position_index(ws, ws))
    jm, tm = jw.swin_attn_mask(h, w, ws, shift), tw.swin_attn_mask(h, w, ws, shift)
    assert (jm is None and tm is None) or (jm.dtype == tm.dtype and np.array_equal(jm, tm))
    x = np.random.default_rng(5).standard_normal((2, h, w, 5)).astype(np.float32)
    parts = tw.window_partition(torch.from_numpy(x), ws)
    assert np.array_equal(parts.numpy(), np.asarray(jw.window_partition(x, ws)))
    assert torch.equal(tw.window_reverse(parts, ws, h, w), torch.from_numpy(x))
    cache = {}
    m1 = tw.shift_mask(cache, h, w, ws, shift, 'cpu')
    assert tw.shift_mask(cache, h, w, ws, shift, 'cpu') is m1
    assert (m1 is None) == (shift == 0) and len(cache) == (shift != 0)
