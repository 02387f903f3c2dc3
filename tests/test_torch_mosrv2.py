"""The port's MoSRv2 and MoESR against resselt_tpu on the same state dicts
(``zoo.make_mosrv2`` / ``zoo.make_moesr``, MetaUpsample buffers included),
on the CPU in f32, with test_mosr_family.py's TOL (5e-4): MoSRv2's
upsampler / scale / unshuffle / RMSNorm cases and MoESR's three upsamplers,
at test_mosr_family.py's widths (dim 16, 2 blocks) on its inputs, with
weights of order one; the band convs' (kh // 2, kw // 2) padding; the
routed convs of the bench configurations; params carried across from a JAX
model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_moesr, make_mosrv2
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 5e-4


def _v2(upsampler='pixelshuffledirect', scale=2, unshuffle=False, rms=True, seed=0):
    return strong(make_mosrv2(16, 2, scale, upsampler=upsampler, unshuffle_mod=unshuffle, rms_norm=rms,
                              seed=seed), seed)


def _moesr(upsampler='pixelshuffledirect', scale=2, seed=0):
    return strong(make_moesr(16, 2, 2, scale, expansion_factor=1.5, expansion_msg=1.5, upsampler=upsampler,
                             upsample_dim=16, seed=seed), seed)


def _x(h, w, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('upsampler,scale,unshuffle,rms', [
    ('pixelshuffledirect', 2, False, False),
    ('pixelshuffle', 4, False, True),
    ('nearest+conv', 2, False, False),
    ('dysample', 2, False, True),
    ('conv', 1, False, False),
    ('pixelshuffledirect', 2, True, True),
    ('pixelshuffledirect', 3, False, False),
])
def test_mosrv2_matches_jax(upsampler, scale, unshuffle, rms):
    tm, _ = both(_v2(upsampler, scale, unshuffle, rms, seed=scale), _x(11, 13), 'MoSRv2', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'MoSRv2')
    cfg = tm.config
    assert (cfg.upsampler, cfg.unshuffle_mod, cfg.rms_norm, cfg.n_block, cfg.dim) == (upsampler, unshuffle, rms, 2, 16)
    assert 'to_img.MetaUpsample' not in tm.params


@pytest.mark.parametrize('upsampler,scale', [('pixelshuffledirect', 2), ('dysample', 4), ('conv', 1)])
def test_moesr_matches_jax(upsampler, scale):
    tm, _ = both(_moesr(upsampler, scale, seed=scale), _x(10, 9), 'MoESR', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'MoESR')
    assert (tm.config.n_blocks, tm.config.n_block, tm.config.expansion_msg) == (2, 2, 1.5)


def test_band_convs_keep_their_shape():
    """The 1 x 11 and 11 x 1 depthwise band convs are padded (0, 5) and
    (5, 0): the mixer keeps the feature map's size."""
    tm = resselt_tpu_torch.load_from_state_dict(make_mosrv2(16, 1, 2), device='cpu')
    w = tm.weights(torch.float32)
    assert [(w[f'gblocks.1.conv.dwconv_{k}'].padding, w[f'gblocks.1.conv.dwconv_{k}'].groups)
            for k in ('hw', 'w', 'h')] == [((1, 1), 2), ((0, 5), 2), ((5, 0), 2)]


def test_mosrv2_4x_routes_its_52_convs(monkeypatch):
    """The bench configuration (dim 64, 24 blocks, 4x, pixelshuffledirect):
    the stem; per block fc1 64 -> 192 (linear) and fc2 96 -> 64 (Mish);
    the tail's 64 -> 128 and 128 -> 64 (Mish); the 64 -> 48 head."""
    tm = resselt_tpu_torch.load_from_state_dict(make_mosrv2(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    assert calls.calls == ([(3, 64, 'linear')] + [(64, 192, 'linear'), (96, 64, 'mish')] * 24
                           + [(64, 128, 'mish'), (128, 64, 'mish'), (64, 48, 'linear')])


def test_moesr_4x_routes_its_122_convs(monkeypatch):
    """The bench configuration (dim 64, 6 Blocks of 6, expansion 2.5 in the
    blocks and the MSG, 4x, pixelshuffledirect): ``in_to_dim``; per block
    fc1 64 -> 320 and fc2 160 -> 64 (Mish); per MSG ``down.0`` 64 -> 16,
    three such blocks, ``up.0`` 64 -> 256 (their lrelu 0.1 in torch); the
    64 -> 48 head."""
    tm = resselt_tpu_torch.load_from_state_dict(make_moesr(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    block = [(64, 320, 'linear'), (160, 64, 'mish')] * 6
    msg = [(64, 16, 'linear')] + block[:6] + [(64, 256, 'linear')]
    assert calls.calls == [(3, 64, 'linear')] + (block + msg) * 6 + [(64, 48, 'linear')]


@pytest.mark.parametrize('make', [lambda: _v2('dysample', seed=5), lambda: _moesr(seed=5)], ids=['mosrv2', 'moesr'])
def test_params_from_numpy_carries_jax_params(make):
    carried_params_match(make(), _x(9, 12), TOL)


@pytest.mark.parametrize('make', [lambda: _v2(seed=6), lambda: _moesr(seed=6)], ids=['mosrv2', 'moesr'])
def test_tiled_matches_jax(make):
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(make(), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
@pytest.mark.parametrize('make', [lambda: _v2('nearest+conv', seed=8), lambda: _moesr(seed=8)],
                         ids=['mosrv2', 'moesr'])
def test_cli_matches_jax(tmp_path, make, extra):
    assert cli_both(tmp_path, make(), extra) == (60, 76, 3)
