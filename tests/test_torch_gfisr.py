"""The port's GFISR and GFISRV2 against resselt_tpu on the same state dicts
(``zoo.make_gfisr`` / ``zoo.make_gfisrv2``), on the CPU in f32, with
test_gfisr.py's and test_gfisrv2.py's TOL (1e-3): their variants (GFISR
with and without ``fft_mode``, the pixel-unshuffle stem at 2x and 1x,
pa_up, non-RGB 4- and 1-channel stems; GFISRV2 pixelshuffledirect,
transpose+conv, the unshuffle stem, non-RGB) at their widths (dim 16,
expansion 1.5) on inputs that are not aligned, with weights of order one;
the rotating inception's branches; the routed convs of the bench
configurations; params carried across from a JAX model; tiled and CLI
output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_gfisr, make_gfisrv2
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _gfisr(fft_mode=True, unshuffle=False, scale=4, upsampler='pixelshuffledirect', in_nc=3, n_blocks=6, seed=0):
    return strong(make_gfisr(16, n_blocks, scale, in_nc, in_nc, fft_mode=fft_mode, upsampler=upsampler, mid_dim=16,
                             pixel_unshuffle=unshuffle, seed=seed), seed)


def _v2(unshuffle=False, scale=4, upsampler='pixelshuffledirect', in_nc=3, n_blocks=5, seed=0):
    return strong(make_gfisrv2(16, n_blocks, scale, in_nc, in_nc, upsampler=upsampler, mid_dim=16,
                               pixel_unshuffle=unshuffle, seed=seed), seed)


def _x(h, w, c=3, seed=3):
    return np.random.default_rng(seed).random((1, h, w, c), dtype=np.float32)


@pytest.mark.parametrize('fft_mode,unshuffle,scale,upsampler', [
    (True, False, 4, 'pixelshuffledirect'), (False, False, 2, 'pa_up'), (True, True, 2, 'pixelshuffledirect'),
    (True, True, 1, 'conv'), (True, False, 2, 'dysample'), (True, False, 3, 'transpose+conv'),
])
def test_gfisr_matches_jax(fft_mode, unshuffle, scale, upsampler):
    tm, _ = both(_gfisr(fft_mode, unshuffle, scale, upsampler, seed=scale), _x(14, 18), 'GFISR', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'GFISR')
    assert (tm.config.fft_mode, tm.config.pixel_unshuffle, tm.config.n_blocks) == (fft_mode, unshuffle, 6)


@pytest.mark.parametrize('in_nc,scale', [(4, 2), (1, 1)])
def test_gfisr_unshuffle_non_rgb(in_nc, scale):
    """A 4-channel 2x and a 1-channel 1x unshuffle stem both read 16
    channels; the MetaUpsample's output width tells them apart."""
    tm, _ = both(_gfisr(unshuffle=True, scale=scale, in_nc=in_nc, n_blocks=4, seed=7), _x(14, 18, in_nc, seed=5),
                 'GFISR', TOL)
    assert tm.metadata == ModelMetadata(in_nc, in_nc, scale, 'GFISR')


@pytest.mark.parametrize('unshuffle,scale,upsampler', [
    (False, 4, 'pixelshuffledirect'), (False, 2, 'transpose+conv'), (True, 2, 'pixelshuffledirect'),
    (False, 2, 'lda'),
])
def test_gfisrv2_matches_jax(unshuffle, scale, upsampler):
    tm, _ = both(_v2(unshuffle, scale, upsampler, seed=scale), _x(15, 21), 'GFISRV2', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'GFISRV2')
    assert (tm.config.pixel_unshuffle, tm.config.n_blocks) == (unshuffle, 5)


@pytest.mark.parametrize('in_nc,scale', [(4, 2), (1, 1)])
def test_gfisrv2_unshuffle_non_rgb(in_nc, scale):
    tm, _ = both(_v2(True, scale, in_nc=in_nc, n_blocks=4, seed=9), _x(16, 20, in_nc, seed=5), 'GFISRV2', TOL)
    assert tm.metadata == ModelMetadata(in_nc, in_nc, scale, 'GFISRV2')


def test_rotating_inception_branches():
    """Block i's module at position o holds op (i + o) % 5: the
    FourierUnit walks from ``fsas`` (block 0) back through the positions,
    and each depthwise conv is built with groups equal to its channels."""
    tm = resselt_tpu_torch.load_from_state_dict(make_gfisr(16, 5), device='cpu')
    names = ('pconv', 'dwconv_hw', 'dwconv_w', 'dwconv_h', 'fsas')
    assert [next(n for n in names if f'net.{i}.conv.{n}.fdc.weight' in tm.params) for i in range(5)] == list(
        reversed(names))
    w = tm.weights(torch.float32)
    assert [(w[f'net.1.conv.{n}'].padding, w[f'net.1.conv.{n}'].groups) for n in names[:3]] == [
        ((1, 1), 2), ((0, 5), 2), ((5, 0), 2)]
    assert (w['net.1.conv.dwconv_h.fpe'].groups, w['net.1.conv.dwconv_h.fdc'].groups) == (4, 4)


@pytest.mark.parametrize('make,calls', [
    (make_gfisr, [(3, 64, 'linear')] + [(64, 192, 'linear'), (96, 64, 'mish')] * 24 + [(64, 48, 'linear')]),
    (make_gfisrv2, [(3, 64, 'linear')] + [(64, 192, 'linear'), (96, 64, 'silu')] * 22
     + [(64, 64, 'silu'), (64, 64, 'linear'), (64, 48, 'linear')]),
], ids=['gfisr', 'gfisrv2'])
def test_4x_routes_its_convs(monkeypatch, make, calls):
    """The bench configurations (dim 64, expansion 1.5, 4x
    pixelshuffledirect; GFISR 24 blocks, GFISRV2 22 and its conv tail): the
    stem, fc1 and fc2 (Mish or SiLU) of each block, the head."""
    tm = resselt_tpu_torch.load_from_state_dict(make(), device='cpu')
    routed = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    assert routed.calls == calls


@pytest.mark.parametrize('make', [lambda: _gfisr(upsampler='dysample', scale=2, seed=6), lambda: _v2(seed=6)],
                         ids=['gfisr', 'gfisrv2'])
def test_params_from_numpy_carries_jax_params(make):
    carried_params_match(make(), _x(9, 12), TOL)


@pytest.mark.parametrize('make', [lambda: _gfisr(scale=2, seed=7), lambda: _v2(scale=2, seed=7)],
                         ids=['gfisr', 'gfisrv2'])
def test_tiled_matches_jax(make):
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(make(), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
@pytest.mark.parametrize('make', [lambda: _gfisr(unshuffle=True, scale=2, seed=8), lambda: _v2(scale=2, seed=8)],
                         ids=['gfisr', 'gfisrv2'])
def test_cli_matches_jax(tmp_path, make, extra):
    assert cli_both(tmp_path, make(), extra) == (60, 76, 3)
