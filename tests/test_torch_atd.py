"""The port's ATD (resselt_tpu_torch) against resselt_tpu on the same state
dicts, on the CPU in f32, with test_atd.py's TOL (2e-3): that test's three
cases (pixelshuffle x2 embed 24, the light pixelshuffledirect x4 embed 48
with category 128, '' x1) plus nearest+conv x4 and the 3conv residual, on
a 19x21 input (flip-mirror pad to 24x24; 576 tokens are not a multiple of
the category size, so AC_MSA pads the sorted sequence with its tail), with
weights strong enough that AC_MSA moves the output by a tenth of its
range; ``_ac_msa`` and ``_atd_ca`` alone against the JAX functions, with
tied similarities; config, metadata and serving hints equal; ``no_norm``;
detection of every ported family in both packages; the zoo's state dicts;
params carried across from a JAX model; tiled and CLI output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu.archs import atd as jatd
from resselt_tpu.nn.params import PTree as JPTree
from resselt_tpu.zoo import make_atd as jax_make_atd
from resselt_tpu_torch.archs import atd as tatd
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.nn.params import PTree
from resselt_tpu_torch.ops import row_gather, window_mha
from resselt_tpu_torch.zoo import (make_atd, make_compact, make_dat, make_drct, make_eimn, make_esrgan, make_fdat,
                                   make_hat, make_mosr, make_omni, make_plksr, make_rcan, make_rgt, make_span,
                                   make_spanplus, make_spanpp, make_swinir)


torch.set_num_threads(2)

TOL = 2e-3

_HINTS = ('tile_batch', 'serving_tile', 'serving_halo', 'size_multiple')


def _strong(sd, seed):
    """The layout of ``sd`` with weights of order 1 / sqrt(fan in), norm
    scales near one, a dictionary of order one and ATD_CA scales in (0, 1):
    every branch then moves the output."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        if v.dtype.kind != 'f':
            out[k] = v
        elif k.endswith('.td'):
            out[k] = rng.standard_normal(v.shape).astype(np.float32)
        elif k.endswith('attn_atd.scale'):
            out[k] = rng.random(v.shape).astype(np.float32)
        elif v.ndim >= 2 and not k.endswith(('sigma', 'logit_scale')):
            out[k] = (rng.standard_normal(v.shape) * 0.7 / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
        elif 'norm' in k and k.endswith('weight'):
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def _sd(upsampler='pixelshuffledirect', upscale=2, embed_dim=24, seed=0, **kw):
    return _strong(make_atd(embed_dim, (2, 2), (3, 3), 8, num_tokens=16, reducted_dim=4, upscale=upscale,
                            upsampler=upsampler, seed=seed, **kw), seed)


def _both(sd, x):
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.arch_id == jm.arch_id == 'ATD'
    assert tm.metadata == ModelMetadata(**vars(jm.metadata))
    assert tm.config.__dict__ == jm.config.__dict__
    assert all(getattr(tm, h) == getattr(jm, h) for h in _HINTS)
    want = np.asarray(jm(x))
    got = tm(x).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < TOL, f'max err {err}'
    return tm, jm


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('upsampler,scale,embed_dim,cat,resi', [
    ('pixelshuffle', 2, 24, 256, '1conv'),
    ('pixelshuffledirect', 4, 48, 128, '1conv'),  # the light heuristic
    ('', 1, 24, 256, '1conv'),
    ('nearest+conv', 4, 24, 256, '1conv'),
    ('pixelshuffle', 3, 24, 256, '3conv'),
    ('pixelshuffledirect', 2, 24, 256, '3conv'),  # direct tail, not light
])
def test_atd_variants(upsampler, scale, embed_dim, cat, resi):
    sd = _sd(upsampler, scale, embed_dim, seed=scale, resi_connection=resi)
    tm, _ = _both(sd, _x(19, 21))
    assert tm.metadata == ModelMetadata(3, 3, scale, 'ATD')
    cfg = tm.config
    assert (cfg.upsampler, cfg.category_size, cfg.resi_connection, cfg.norm) == (upsampler, cat, resi, True)
    assert (cfg.num_tokens, cfg.reducted_dim, cfg.convffn_kernel_size, cfg.window_size) == (16, 4, 5, 8)
    assert tm.tile_batch == {'f32': 1, 'bf16': 2} and tm.serving_halo == {'f32': 16, 'bf16': 8}


def test_ac_msa_moves_the_output():
    """The parity above is a check of AC_MSA only if AC_MSA matters."""
    sd = _sd('pixelshuffledirect', 4, 48, seed=4)
    x = _x(19, 21)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    off = {k: np.zeros_like(v) if 'attn_aca.proj' in k else v for k, v in sd.items()}
    without = resselt_tpu_torch.load_from_state_dict(off, device='cpu')(x)
    assert float((tm(x) - without).abs().max()) > 0.1


def test_atd_no_norm():
    sd = _sd('pixelshuffle', 2, seed=6)
    sd['no_norm'] = np.zeros((1,), np.float32)
    tm, _ = _both(sd, _x(16, 13))
    assert tm.config.norm is False and 'no_norm' not in tm.params


@pytest.mark.parametrize('n,category,tied', [(64, 32, False), (80, 32, False), (80, 32, True), (24, 256, True)],
                         ids=['even', 'pad_tail', 'pad_tail_ties', 'one_group'])
def test_ac_msa_matches_jax(n, category, tied):
    rng = np.random.default_rng(n)
    b, c, heads, tokens = 2, 24, 3, 8
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    sim = rng.random((b, n, tokens)).astype(np.float32)
    if tied:  # equal maxima: argmax takes the first, the sort keeps the order
        sim = np.round(sim * 3) / 3
    params = {'logit_scale': np.full((1, 1), 1.3, np.float32),
              'proj.weight': (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
              'proj.bias': rng.standard_normal(c).astype(np.float32)}
    want = np.asarray(jatd._ac_msa(JPTree({k: jnp.asarray(v) for k, v in params.items()}), jnp.asarray(qkv),
                                   jnp.asarray(sim), heads, category))
    before = row_gather.launches
    got = tatd._ac_msa(PTree({k: torch.from_numpy(v) for k, v in params.items()}), torch.from_numpy(qkv),
                       torch.from_numpy(sim), heads, category)
    assert row_gather.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_atd_ca_matches_jax():
    rng = np.random.default_rng(1)
    b, n, c, tokens, rdim = 2, 40, 24, 16, 4
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    td = rng.standard_normal((b, tokens, c)).astype(np.float32)
    params = {'scale': (rng.random(tokens) * 1.4 - 0.2).astype(np.float32)}  # clipped to [0, 1] at both ends
    for name, od in (('wq', rdim), ('wk', rdim), ('wv', c)):
        params[f'{name}.weight'] = (rng.standard_normal((od, c)) / np.sqrt(c)).astype(np.float32)
        params[f'{name}.bias'] = (0.1 * rng.standard_normal(od)).astype(np.float32)
    params['wq.bias'][:] = 0.0
    x[0, 0] = 0.0  # a zero query: the norm's 1e-12 floor
    want_out, want_sim = jatd._atd_ca(JPTree({k: jnp.asarray(v) for k, v in params.items()}), jnp.asarray(x),
                                      jnp.asarray(td), tokens)
    out, sim = tatd._atd_ca(PTree({k: torch.from_numpy(v) for k, v in params.items()}), torch.from_numpy(x),
                            torch.from_numpy(td), tokens)
    np.testing.assert_allclose(sim.numpy(), np.asarray(want_sim), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-4, atol=1e-5)


def test_instance_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 50)).astype(np.float32)
    w, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    want = np.asarray(jatd._instance_norm1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tatd._instance_norm1d(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_zoo_make_atd_is_the_jax_one():
    for kw in (dict(), dict(embed_dim=24, depths=(2, 3), num_heads=(3, 4), window_size=16, num_tokens=8,
                            reducted_dim=4, convffn_kernel_size=7, mlp_ratio=2.0, upscale=4, seed=5)):
        a, b = make_atd(**kw), jax_make_atd(**kw)
        assert list(a) == list(b)
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def test_zoo_atd_light_full_width_layout():
    """ATD-light 4x: embed 48, depths (6,) x 5, heads (4,) x 5, window 16,
    64 tokens, reducted dim 8, ConvFFN kernel 7, mlp ratio 1."""
    sd = make_atd(48, (6,) * 5, (4,) * 5, 16, num_tokens=64, reducted_dim=8, convffn_kernel_size=7, mlp_ratio=1.0,
                  upscale=4)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    cfg = tm.config
    assert cfg.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (cfg.embed_dim, cfg.depths, cfg.num_heads, cfg.window_size) == (48, (6,) * 5, (4,) * 5, 16)
    assert (cfg.category_size, cfg.num_tokens, cfg.upsampler, cfg.upscale) == (128, 64, 'pixelshuffledirect', 4)
    assert sd['layers.4.residual_group.layers.5.wqkv.weight'].shape == (144, 48)
    assert 'layers.0.residual_group.layers.5.sigma' not in sd and 'layers.0.residual_group.layers.4.sigma' in sd


def test_detection_of_all_six_families():
    """Every ported family (all thirty-one since RTMoSR, SMoSR, RHA,
    FlexNet and the four spectral families) detects as itself, and only as
    itself, in both packages; the port registers them in JAX's order."""
    cases = ((_sd(), 'ATD', 'ATD'), (_sd('nearest+conv', 4), 'ATD', 'ATD'),
             (make_hat(24, (2,), (3,), 8, upscale=2), 'HAT', 'HAT'),
             (make_swinir(24, (2,), (3,), 8, upscale=2, img_size=32), 'SwinIR', 'SwinIR'),
             (make_esrgan(16, 1, 2, gc=8), 'ESRGAN', 'ESRGAN'), (make_plksr(16, 1, 2), 'PLKSR', 'PLKSR'),
             (make_eimn(16, 1, 1, 1.5, 2), 'eimn', 'EIMN'),
             (make_dat(24, (2,), (2,), (2, 4), 2.0, 2), 'dat', 'DAT'),
             (make_dat(24, (2,), (2,), (2, 4), 2.0, 2, 'pixelshuffledirect', '3conv'), 'dat', 'DAT'),
             (make_rgt(24, (2,), (2,), (4, 4), 2.0, 0.5, 2), 'RGT', 'RGT'),
             (make_rgt(24, (2,), (2,), (2, 8), 2.0, 0.5, 2, '3conv'), 'RGT', 'RGT'),
             (make_drct(24, 1, 3, 8, 8, 2.0, 2, img_size=32), 'DRCT', 'DRCT'),
             (make_drct(24, 1, 3, 8, 8, 2.0, 2, attn_masks=False), 'DRCT', 'DRCT'),
             (make_fdat(32, 1, 1, 4, 8, 1.5, 8, 32, 'transpose+conv', 4), 'FDAT', 'FDAT'),
             (make_omni(16, 1, True, 8, 1, 2), 'OmniSR', 'OmniSR'),
             (make_compact(16, 2, 2), 'Compact', 'Compact'), (make_span(16, 2), 'SPAN', 'SPAN'),
             (make_spanplus(16, (2,), 2), 'spanplus', 'SPANPlus'), (make_mosr(16, 2, 2), 'MoSR', 'MoSR'),
             (make_spanpp(16, implicit_dim=32, latent_layers=2), 'SpanPP', 'SpanPP'),
             (make_rcan(16, 2, 2, 4, 2), 'RCAN', 'RCAN'))
    for sd, arch, name in cases:
        tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
        jm = resselt_tpu.load_from_state_dict(sd)
        assert tm.arch_id == jm.arch_id == arch and tm.metadata.name == jm.metadata.name == name
        hits = [a.id for a in resselt_tpu_torch.archs.internal_registry if a.detect(sd)]
        assert hits == [a.id for a in resselt_tpu.archs.internal_registry if a.detect(sd)] == [arch]
    port = [a.id for a in resselt_tpu_torch.archs.internal_registry]
    assert port == [a.id for a in resselt_tpu.archs.internal_registry if a.id in port]
    assert port == ['SwinIR', 'HAT', 'OmniSR', 'DRCT', 'FDAT', 'dat', 'RGT', 'ATD', 'SpanPP', 'SPAN', 'ESRGAN', 'PLKSR',
                    'MoSRv2', 'MoESR', 'RTMoSR', 'SMoSR', 'RHA', 'FlexNet', 'GateRV3', 'GateRv2', 'LAWFFT',
                    'GFISRV2', 'FIGSR', 'GFISR', 'GateR', 'CuGAN', 'RCAN', 'eimn', 'MoSR', 'Compact', 'spanplus']


def test_params_from_numpy_carries_jax_params():
    sd = _sd('pixelshuffledirect', 2, seed=10)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    assert not carried['relative_position_index_SA'].is_floating_point()  # JAX holds it as int32
    x = _x(11, 9)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < TOL


def test_tiled_matches_jax():
    """AC_MSA groups a window's tokens by whole-window statistics, so tiled
    is compared with tiled, on the same grid."""
    sd = _sd('pixelshuffle', 2, seed=4)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    # tile 16 off the hint: the f32 halo 16 already makes 48x48 windows
    # multiples of the window size; one window per batch (tile_batch f32: 1)
    assert tt._resolve_halo_hint(tm, 16, torch.float32) == jt._resolve_halo_hint(jm, 16, np.float32) == 16
    want = np.asarray(jt.upscale_tiled(jm, img, tile=16))
    got = tt.upscale_tiled(tm, img, tile=16).numpy()
    assert got.shape == want.shape == (80, 92, 3)
    assert float(np.abs(got - want).max()) < TOL


def test_prepared_bias_masks_and_cpu_launch_count():
    tm = resselt_tpu_torch.load_from_state_dict(_sd('pixelshuffle', 2, seed=6), device='cpu')
    w32 = tm.weights(torch.float32)
    assert tm.weights(torch.float32) is w32
    key = 'layers.1.residual_group.layers.1.attn_win.relative_position_bias'
    bias = w32[key]
    assert bias.shape == (3, 64, 64) and bias.dtype == torch.float32 and bias.is_contiguous()
    table = tm.params['layers.1.residual_group.layers.1.attn_win.relative_position_bias_table']
    rpi = tm.params['relative_position_index_SA']
    assert torch.equal(bias[2, 5, 9], table[rpi[5, 9], 2])
    wb = tm.weights(torch.bfloat16)
    assert wb[key].dtype == torch.float32 and torch.equal(wb[key], bias.to(torch.bfloat16).float())
    assert wb['layers.0.residual_group.layers.0.wqkv.weight'].dtype == torch.bfloat16
    assert wb['relative_position_index_SA'].dtype == torch.int64
    before = window_mha.launches, row_gather.launches
    y = tm(_x(20, 28))
    assert set(w32['shift_masks']) == {(24, 32, 8, 4, 'cpu')}  # one mask for every shifted layer
    yb = tm(_x(20, 28), dtype=torch.bfloat16)
    assert (window_mha.launches, row_gather.launches) == before
    assert y.shape == (1, 40, 56, 3) and yb.dtype == torch.bfloat16 and bool(torch.isfinite(yb).all())


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    from PIL import Image

    from resselt_tpu.upscale import main as jax_main
    from resselt_tpu_torch.io import write_safetensors
    from resselt_tpu_torch.upscale import main as port_main

    ckpt = str(tmp_path / 'm.safetensors')
    write_safetensors(_sd('pixelshuffle', 2, seed=8), ckpt)
    src = str(tmp_path / 'in.png')
    Image.fromarray((np.random.default_rng(8).random((40, 46, 3)) * 255).astype(np.uint8)).save(src)
    a, b = str(tmp_path / 'jax.png'), str(tmp_path / 'port.png')
    assert jax_main([ckpt, src, a, *extra]) == 0
    assert port_main([ckpt, src, b, '--device', 'cpu', *extra]) == 0
    ja, pb = (np.asarray(Image.open(p)).astype(np.int16) for p in (a, b))
    assert ja.shape == pb.shape == (80, 92, 3)
    assert int(np.abs(ja - pb).max()) <= 1
