"""float16, ``precision`` and the mask-window flags of resselt_tpu_torch.

* ``precision``: 'bfloat16' runs on the CPU and restores torch's global
  matmul / cuDNN settings; an unknown string raises.
* float16 through each of the five kernel wrappers on the CPU (their plain
  versions) against the JAX op on the same numpy inputs: the inputs are
  rounded to float16 with numpy, the port gets them as float16, JAX gets
  the same values as float32 (its Pallas kernels run in interpret mode, as
  tests/test_pallas_ops.py runs them), and the port's float16 output is held
  to rtol 2e-2 + atol 1e-2: the output's float16 rounding.  The row gather
  is exact.
* ``model(x, dtype='float16')`` for the seventeen served families at the small
  sizes of their parity tests: at least 35 dB PSNR against the port's own
  float32 output and against resselt_tpu's float16 output.
* ``mask_window_flags``: equal to ``(mask != 0).any((1, 2))``, 2 x side - 1
  non-zero windows for a Swin shift mask, cached per mask tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu_torch
from resselt_tpu.nn.params import PTree as JPTree
from resselt_tpu.ops.fused_conv import fused_conv3x3_act as jax_act, fused_conv_lk as jax_lk
from resselt_tpu.ops.molrcm import fused_molrcm as jax_fused_molrcm
from resselt_tpu.ops.window_attention import window_mha_pallas
from resselt_tpu_torch.core.factory import _precision
from resselt_tpu_torch.nn.params import PTree
from resselt_tpu_torch.nn.window import swin_attn_mask
from resselt_tpu_torch.ops import fused_conv as fc
from resselt_tpu_torch.ops import molrcm as mo
from resselt_tpu_torch.ops import row_gather
from resselt_tpu_torch.ops import window_attention as wa
from resselt_tpu_torch.zoo import (make_atd, make_compact, make_dat, make_drct, make_eimn, make_esrgan, make_fdat,
                                   make_hat, make_mosr, make_omni, make_plksr, make_rcan, make_rgt, make_span,
                                   make_spanplus, make_spanpp, make_swinir)


torch.set_num_threads(2)

F16_RTOL, F16_ATOL = 2e-2, 1e-2  # the output's float16 rounding
PSNR_DB = 35.0                   # tests/test_parallel.py's floor for a 16-bit run against f32


def _precision_state():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


# -- precision ------------------------------------------------------------------


@pytest.mark.parametrize('precision,inside', [('bfloat16', (True, True, 'medium')),
                                              ('tensorfloat32', (True, True, 'high')),
                                              ('highest', (False, False, 'highest'))])
def test_precision_sets_and_restores_the_global_settings(precision, inside):
    before = _precision_state()
    with _precision(precision):
        assert _precision_state() == inside
    assert _precision_state() == before
    with pytest.raises(RuntimeError, match='inside'):  # restored when the body raises, too
        with _precision(precision):
            raise RuntimeError('inside')
    assert _precision_state() == before


def test_precision_none_touches_nothing_and_unknown_raises():
    before = _precision_state()
    with _precision(None):
        assert _precision_state() == before
    with pytest.raises(ValueError, match='precision'):
        with _precision('float8'):
            pass
    assert _precision_state() == before


@pytest.mark.parametrize('precision', ['bfloat16', 'tensorfloat32', 'highest', None])
def test_model_takes_every_precision_on_the_cpu(precision):
    tm = resselt_tpu_torch.load_from_state_dict(make_esrgan(16, 1, 2, gc=8, seed=1), device='cpu')
    x = np.random.default_rng(0).random((1, 9, 11, 3), dtype=np.float32)
    before = _precision_state()
    got = tm(x, precision=precision)
    assert _precision_state() == before
    if precision in ('highest', None):
        assert torch.equal(got, tm(x))
    else:  # the CPU's matmuls may take the lower precision, as the card's do
        torch.testing.assert_close(got, tm(x), rtol=0, atol=2e-2)
    with pytest.raises(ValueError):
        tm(x, precision='fastest')


# -- float16 through the five wrappers ---------------------------------------------


def _f16(a):
    """``a`` rounded to float16: (the float16 array, the same values in f32)."""
    h = np.asarray(a, np.float32).astype(np.float16)
    return h, h.astype(np.float32)


def _close16(got: torch.Tensor, want: np.ndarray):
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=F16_RTOL, atol=F16_ATOL)


@pytest.mark.parametrize('act', ['linear', 'lrelu', 'silu', 'mish'])
@pytest.mark.parametrize('shape', [(32, 128, 64, 64), (16, 128, 3, 64)])
def test_fused_conv3x3_float16_matches_pallas(act, shape):
    h, w, cin, cout = shape
    rng = np.random.default_rng(0)
    x16, x32 = _f16(rng.standard_normal((h, w, cin)))
    w16, w32 = _f16(rng.standard_normal((cout, cin, 3, 3)) * 0.05)
    b = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jax_act(x32, w32, b, act=act, interpret=True))
    got = fc.fused_conv3x3_act(torch.from_numpy(x16), torch.from_numpy(w16), torch.from_numpy(b), act=act)
    _close16(got, want)
    # packed float16 taps give the same
    taps = fc.pack_conv3x3_weight(torch.from_numpy(w32), torch.float16)
    assert taps.dtype == torch.float16
    assert torch.equal(fc.fused_conv3x3_act(torch.from_numpy(x16), taps, torch.from_numpy(b), act=act), got)


@pytest.mark.parametrize('act', ['linear', 'lrelu'])
@pytest.mark.parametrize('h,w,cin,cout,k', [(20, 128, 16, 16, 17), (16, 128, 32, 24, 9)])
def test_fused_conv_lk_float16_matches_pallas(act, h, w, cin, cout, k):
    rng = np.random.default_rng(k)
    x16, x32 = _f16(rng.standard_normal((1, h, w, cin)))
    w16, w32 = _f16(rng.standard_normal((cout, cin, k, k)) / (k * cin ** 0.5))
    b = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jax_lk(x32, w32, b, k=k, act=act, interpret=True))
    got = fc.fused_conv_lk(torch.from_numpy(x16), torch.from_numpy(w16), torch.from_numpy(b), k=k, act=act)
    _close16(got, want)


@pytest.mark.parametrize('n,c,heads,masked', [(64, 180, 6, True), (256, 48, 4, True), (256, 144, 6, False),
                                              (49, 60, 6, True)])
def test_window_mha_float16_matches_pallas(n, c, heads, masked):
    rng = np.random.default_rng(n + c)
    nw, b = 4, 2
    (q16, q32), (k16, k32), (v16, v32) = (_f16(rng.standard_normal((b * nw, n, c))) for _ in range(3))
    bias = (rng.standard_normal((heads, n, n)) * 0.1).astype(np.float32)
    mask = np.where(rng.random((nw, n, n)) < 0.2, -100.0, 0.0).astype(np.float32) if masked else None
    scale = (c // heads) ** -0.5
    want = np.asarray(window_mha_pallas(q32, k32, v32, bias, mask, num_heads=heads, scale=scale, interpret=True))
    got = wa.window_mha(torch.from_numpy(q16), torch.from_numpy(k16), torch.from_numpy(v16), torch.from_numpy(bias),
                        None if mask is None else torch.from_numpy(mask), num_heads=heads, scale=scale)
    _close16(got, want)


@pytest.mark.parametrize('shape,th', [((2, 37, 45, 64), 16), ((1, 16, 128, 64), 8)])
def test_fused_molrcm_float16_matches_pallas(shape, th):
    d = shape[-1]
    rng = np.random.default_rng(0)
    c1, c2 = int(3 / 8 * d), int(1 / 8 * d)
    params = {}
    for name, (o, i, k) in {'proj_value.0': (d, d, 1), 'proj_query.0': (d, d, 1), 'region': (d, 1, 5),
                            'spatial_1': (c1, 1, 5), 'spatial_2': (d - c1 - c2, 1, 7), 'fusion': (d, d, 1),
                            'out': (d, d, 1)}.items():
        params[f'{name}.weight'] = _f16(rng.standard_normal((o, i, k, k)) * 0.1)[1]
        params[f'{name}.bias'] = _f16(rng.standard_normal((o,)) * 0.1)[1]
    x16, x32 = _f16(rng.standard_normal(shape) * 0.3)
    jp = JPTree({k: jnp.asarray(v) for k, v in params.items()})
    want = np.asarray(jax_fused_molrcm(jp, jnp.asarray(x32), d, th=th, interpret=True))
    packed = mo.pack_molrcm_weights(PTree({k: torch.from_numpy(v) for k, v in params.items()}), torch.float16)
    assert packed.dtype == torch.float32  # float16-rounded values in the kernel's f32 buffer
    got = mo.fused_molrcm(torch.from_numpy(x16), packed)
    _close16(got, want)


@pytest.mark.parametrize('idx_dtype', [np.int32, np.int64])
@pytest.mark.parametrize('rows_src,rows_out,width', [(2 * 576, 2 * 576, 144), (2 * 768, 2 * 576, 48), (100, 250, 7)])
def test_row_gather_float16_is_exact(idx_dtype, rows_src, rows_out, width):
    rng = np.random.default_rng(width)
    src16, _ = _f16(rng.standard_normal((rows_src, width)))
    idx = rng.integers(0, rows_src, rows_out).astype(idx_dtype)
    want = np.asarray(jnp.take(jnp.asarray(src16), jnp.asarray(idx), axis=0))
    got = row_gather(torch.from_numpy(src16), torch.from_numpy(idx))
    assert got.dtype == torch.float16 and got.is_contiguous()
    assert np.array_equal(got.numpy(), want)


# -- float16 through the eleven families --------------------------------------------


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    return float(10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12)))


_FAMILIES = {
    'esrgan': (lambda: make_esrgan(16, 2, 4, gc=8, seed=3), (13, 17)),
    'plksr': (lambda: make_plksr(16, 2, 2, kernel_size=9, seed=3), (13, 17)),
    'swinir': (lambda: make_swinir(24, (2, 2), (3, 3), 8, upscale=2, img_size=32, seed=3), (16, 24)),
    'eimn': (lambda: make_eimn(embed_dims=64, num_stages=2, depths=1, mlp_ratio=2.66, scale=4, seed=3), (12, 14)),
    'atd': (lambda: make_atd(24, (2, 2), (3, 3), 8, num_tokens=16, reducted_dim=4, upscale=2, seed=3), (16, 24)),
    'hat': (lambda: make_hat(24, (2, 2), (3, 3), 8, 0.5, 3, 8, 2.0, 2, seed=3), (16, 24)),
    'dat': (lambda: make_dat(24, (2, 2), (4, 2), (2, 4), 2.0, 2, seed=3), (18, 22)),
    'rgt': (lambda: make_rgt(24, (2, 2), (4, 2), (4, 8), 2.0, 0.5, 2, seed=3), (20, 24)),
    'drct': (lambda: make_drct(24, 2, 3, 8, 8, 2.0, 2, img_size=32, seed=3), (16, 24)),
    'fdat': (lambda: make_fdat(32, 1, 1, 4, 8, 1.5, 8, 24, 'pa_up', 2, seed=3), (17, 21)),
    'omni': (lambda: make_omni(16, 1, True, 8, 1, 2, seed=3), (22, 18)),
    'compact': (lambda: make_compact(16, 2, 2, seed=3), (13, 17)),
    'span': (lambda: make_span(16, 2, seed=3, norm=False), (13, 17)),
    'spanplus': (lambda: make_spanplus(16, (2,), 2, seed=3), (13, 17)),
    'mosr': (lambda: make_mosr(16, 2, 2, seed=3), (13, 17)),
    'spanpp': (lambda: make_spanpp(16, implicit_dim=32, latent_layers=2, seed=3), (13, 17)),
    'rcan': (lambda: make_rcan(16, 2, 2, 4, 2, seed=3), (13, 17)),
}


@pytest.mark.parametrize('family', sorted(_FAMILIES))
def test_model_serves_float16_on_the_cpu(family):
    make, (h, w) = _FAMILIES[family]
    sd = make()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    jm = resselt_tpu.load_from_state_dict(sd)
    x = np.random.default_rng(0).random((1, h, w, 3), dtype=np.float32)
    got = tm(x, dtype='float16')
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    got = got.float().numpy()
    f32 = tm(x).numpy()
    assert got.shape == f32.shape
    assert _psnr(got, f32) >= PSNR_DB, f'float16 vs the port f32: {_psnr(got, f32):.2f} dB'
    jax16 = np.asarray(jm(x, dtype=jnp.float16)).astype(np.float32)
    assert _psnr(got, jax16) >= PSNR_DB, f'float16 vs resselt_tpu float16: {_psnr(got, jax16):.2f} dB'


# -- the mask-window flags ----------------------------------------------------------


@pytest.mark.parametrize('h,w,ws,shift', [(64, 64, 8, 4), (256, 256, 16, 8), (28, 28, 7, 3)])
def test_mask_window_flags_of_a_shift_mask(h, w, ws, shift):
    mask = torch.from_numpy(swin_attn_mask(h, w, ws, shift))
    flags = wa.mask_window_flags(mask)
    assert flags.dtype == torch.uint8 and flags.shape == (mask.shape[0],) and flags.is_contiguous()
    assert torch.equal(flags.bool(), (mask != 0).any((1, 2)))
    side = h // ws
    assert int(flags.sum()) == 2 * side - 1  # the last row and column of windows
    # the last row and the last column of windows, and no other
    grid = flags.reshape(side, side).bool()
    assert bool(grid[-1].all()) and bool(grid[:, -1].all()) and not bool(grid[:-1, :-1].any())
    assert wa.mask_window_flags(mask) is flags  # once per mask tensor


def test_mask_window_flags_follow_the_mask():
    mask = torch.zeros((4, 16, 16))
    assert int(wa.mask_window_flags(mask).sum()) == 0
    mask[2, 3, 5] = -100.0  # written in place: scanned again
    assert wa.mask_window_flags(mask).tolist() == [0, 0, 1, 0]
    dense = torch.full((3, 16, 16), -100.0)
    assert wa.mask_window_flags(dense).tolist() == [1, 1, 1]
    # skipping an all-zero window's tile changes nothing: masked == unmasked there
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((8, 16, 32)).astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((4, 16, 16)).astype(np.float32))
    with_mask = wa.window_mha(q, k, v, bias, mask, num_heads=4, scale=0.3)
    without = wa.window_mha(q, k, v, bias, None, num_heads=4, scale=0.3)
    zero_windows = [i for i in range(8) if i % 4 != 2]
    assert torch.equal(with_mask[zero_windows], without[zero_windows])
    assert not torch.equal(with_mask[2], without[2])
