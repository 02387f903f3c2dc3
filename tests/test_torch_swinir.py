"""The port's SwinIR (resselt_tpu_torch) against resselt_tpu on the same
state dicts, on the CPU in f32, with test_swinir.py's TOL (2e-3, for
transformer stacks): the upsamplers pixelshuffle x2/x4, pixelshuffledirect
x3, nearest+conv x4 and '' x1 on an odd 21x27 input (pad-to-window and
shifted masks), the 3conv residual, window 7 with img_range 255 and
start_unshuffle; config, metadata and serving hints equal; detection
(ESRGAN and PLKSR still detect as themselves with SwinIR registered
first); the zoo's state dicts; params carried across from a JAX model;
tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu.parallel.tiling as jt
import resselt_tpu_torch
import resselt_tpu_torch.parallel.tiling as tt
from resselt_tpu.zoo import make_swinir as jax_make_swinir
from resselt_tpu_torch.core import ModelMetadata, params_from_numpy
from resselt_tpu_torch.ops import window_attention as wa
from resselt_tpu_torch.zoo import make_esrgan, make_plksr, make_realplksr, make_swinir


torch.set_num_threads(2)

TOL = 2e-3

_HINTS = ('tile_batch', 'serving_tile', 'serving_halo', 'size_multiple')


def _sd(upsampler='pixelshuffle', upscale=2, window_size=8, img_size=32, seed=0, **kw):
    return make_swinir(24, (2, 2), (3, 3), window_size, upscale=upscale, upsampler=upsampler, img_size=img_size,
                       seed=seed, **kw)


def _three_conv(sd, e=24):
    """The '3conv' residual: conv(e, e/4, 3), lrelu, conv(e/4, e/4, 1),
    lrelu, conv(e/4, e, 3) in place of each single conv."""
    rng = np.random.default_rng(9)
    sd = dict(sd)
    keys = [k[:-len('.weight')] for k in sd if k.endswith('.conv.weight') or k == 'conv_after_body.weight']
    for key in keys:
        del sd[f'{key}.weight'], sd[f'{key}.bias']
        for i, (co, ci, kk) in zip((0, 2, 4), ((e // 4, e, 3), (e // 4, e // 4, 1), (e, e // 4, 3))):
            sd[f'{key}.{i}.weight'] = (rng.standard_normal((co, ci, kk, kk)) * 0.05).astype(np.float32)
            sd[f'{key}.{i}.bias'] = (rng.standard_normal(co) * 0.05).astype(np.float32)
    return sd


def _both(sd, x, direct=False):
    """Load ``sd`` in both packages (``direct``: through the SwinIR loaders,
    skipping detection) and compare the forward on ``x``."""
    if direct:
        from resselt_tpu.archs.swinir import ARCH as jax_arch
        from resselt_tpu_torch.archs.swinir import ARCH as port_arch

        jm, tm = jax_arch.load(sd), port_arch.load(sd, device='cpu')
    else:
        jm = resselt_tpu.load_from_state_dict(sd)
        tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.arch_id == jm.arch_id == 'SwinIR'
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


@pytest.mark.parametrize('upsampler,upscale', [
    ('pixelshuffle', 2), ('pixelshuffle', 4), ('pixelshuffledirect', 3), ('nearest+conv', 4), ('', 1),
])
def test_swinir_variants(upsampler, upscale):
    tm, _ = _both(_sd(upsampler, upscale, seed=upscale), _x(21, 27))
    assert tm.metadata == ModelMetadata(3, 3, upscale, 'SwinIR')
    assert tm.config.upsampler == upsampler and tm.config.img_size == 32


def test_swinir_3conv_resi():
    tm, _ = _both(_three_conv(_sd('pixelshuffle', 2, seed=5)), _x(16, 16))
    assert tm.config.resi_connection == '3conv'


def test_swinir_window7_img_range():
    """window 7 -> img_range 255 (the reference's heuristic, kept)."""
    tm, _ = _both(_sd('', 1, window_size=7, img_size=28, seed=6), _x(14, 15))
    assert tm.config.img_range == 255.0 and tm.config.window_size == 7 and tm.size_multiple == 7


def test_swinir_start_unshuffle():
    sd = _sd('pixelshuffle', 2, seed=7)
    rng = np.random.default_rng(7)
    del sd['conv_first.weight']
    sd['conv_first.1.weight'] = (rng.standard_normal((24, 12, 3, 3)) * 0.03).astype(np.float32)
    sd['conv_first.1.bias'] = sd.pop('conv_first.bias')
    # detection needs conv_first.weight in both packages, so such a
    # checkpoint is loaded through the SwinIR loader itself
    for pkg in (resselt_tpu, resselt_tpu_torch):
        assert not any(a.detect(sd) for a in pkg.archs.internal_registry)
    tm, _ = _both(sd, _x(13, 18), direct=True)
    assert tm.config.start_unshuffle == 2 and tm.metadata.in_channels == 3


def test_zoo_make_swinir_is_the_jax_one():
    for ups, s in (('pixelshuffle', 4), ('pixelshuffle', 3), ('pixelshuffledirect', 2), ('', 1)):
        a = make_swinir(30, (2, 4), (6, 3), 8, upscale=s, upsampler=ups, img_size=48, seed=s)
        b = jax_make_swinir(30, (2, 4), (6, 3), 8, upscale=s, upsampler=ups, img_size=48, seed=s)
        assert list(a) == list(b)
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def test_zoo_swinir_m_full_width_layout():
    """SwinIR-M x4 classical: embed 180, depths and heads (6,) x 6, window 8."""
    sd = make_swinir(180, (6,) * 6, (6,) * 6, 8, upscale=4, img_size=64)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert tm.config.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (tm.config.embed_dim, tm.config.depths, tm.config.num_heads) == (180, (6,) * 6, (6,) * 6)
    assert (tm.config.img_size, tm.config.upsampler, tm.config.resi_connection) == (64, 'pixelshuffle', '1conv')
    assert not any(k.endswith('attn_mask') for k in tm.params)


def test_detection_with_swinir_first():
    for sd, arch, name in ((_sd(), 'SwinIR', 'SwinIR'), (_sd('nearest+conv', 4), 'SwinIR', 'SwinIR'),
                           (make_esrgan(16, 1, 2, gc=8), 'ESRGAN', 'ESRGAN'),
                           (make_plksr(16, 1, 2), 'PLKSR', 'PLKSR'), (make_realplksr(16, 1, 2), 'PLKSR', 'RealPLKSR')):
        tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
        jm = resselt_tpu.load_from_state_dict(sd)
        assert tm.arch_id == jm.arch_id == arch and tm.metadata.name == jm.metadata.name == name
    assert [a.id for a in resselt_tpu_torch.archs.internal_registry][0] == 'SwinIR'


def test_params_from_numpy_carries_jax_params():
    sd = _sd('pixelshuffledirect', 2, seed=10)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, 'cpu')
    assert set(carried) == set(tm.params)
    x = _x(11, 9)
    want = np.asarray(jm(x))
    got = tm.apply(carried, torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < TOL


def test_tiled_matches_jax():
    sd = _sd('pixelshuffle', 2, seed=4)
    jm = resselt_tpu.load_from_state_dict(sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    # tile 16 off the hint: the halo is derived to 8, so the 32x32 windows
    # are multiples of the window size; one window per batch (tile_batch 1)
    assert tt._resolve_halo_hint(tm, 16, torch.float32) == jt._resolve_halo_hint(jm, 16, np.float32) == 8
    want = np.asarray(jt.upscale_tiled(jm, img, tile=16))
    got = tt.upscale_tiled(tm, img, tile=16).numpy()
    assert got.shape == want.shape == (80, 92, 3)
    assert float(np.abs(got - want).max()) < TOL


def test_prepared_bias_masks_and_cpu_launch_count():
    tm = resselt_tpu_torch.load_from_state_dict(_sd('pixelshuffle', 2, seed=6), device='cpu')
    w32 = tm.weights(torch.float32)
    assert tm.weights(torch.float32) is w32
    key = 'layers.1.residual_group.blocks.1.attn.relative_position_bias'
    bias = w32[key]
    assert bias.shape == (3, 64, 64) and bias.dtype == torch.float32 and bias.is_contiguous()
    table = tm.params['layers.1.residual_group.blocks.1.attn.relative_position_bias_table']
    rpi = tm.params['layers.1.residual_group.blocks.1.attn.relative_position_index']
    assert torch.equal(bias[2, 5, 9], table[rpi[5, 9], 2])
    wb = tm.weights(torch.bfloat16)
    assert wb[key].dtype == torch.float32 and torch.equal(wb[key], bias.to(torch.bfloat16).float())
    assert wb['layers.0.residual_group.blocks.0.attn.qkv.weight'].dtype == torch.bfloat16
    before = wa.window_mha.launches
    y32 = tm(_x(20, 28))
    assert set(w32['shift_masks']) == {(24, 32, 8, 4, 'cpu')}  # one mask for every shifted block
    yb = tm(_x(20, 28), dtype=torch.bfloat16)
    assert wa.window_mha.launches == before
    assert yb.dtype == torch.bfloat16
    mse = float(((yb.float() - y32) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35


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


@pytest.mark.parametrize('h,w,multiple', [(21, 27, 8), (2, 3, 8), (1, 5, 7), (16, 16, 8)])
def test_pad_to_multiple_matches_jax(h, w, multiple):
    """Reflect padding as jnp.pad has it, also where the pad is longer than
    the image (tiled strips of a few rows)."""
    from resselt_tpu.nn import functional as JF
    from resselt_tpu_torch.nn import functional as TF

    x = np.random.default_rng(h * w).standard_normal((2, h, w, 3)).astype(np.float32)
    want = np.asarray(JF.pad_to_multiple(x, multiple, mode='reflect'))
    got = TF.pad_to_multiple(torch.from_numpy(x), multiple).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
