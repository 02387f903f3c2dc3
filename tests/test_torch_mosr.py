"""The port's MoSR against resselt_tpu on the same state dicts
(``zoo.make_mosr``), on the CPU in f32, with test_conv_archs.py's TOL
(5e-4): each upsampler (``ps``, ``dys``, ``gps``) at 2x and 4x, and ``ps``
at 3x, at test_conv_archs.py's widths (2 blocks, dim 16, expansion 1.5,
conv ratio 1.0, kernel 7) on its 11x13 input, with weights of order one;
config and metadata equal; the zoo's ``ps`` builder equal to JAX's; ``mosr
4x``'s 54 routed convs (fc1 linear, fc2 and the tail's and shortcut's convs
with Mish fused; the depthwise conv and the 1x1s stay F.conv2d); params
carried across from a JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu.zoo import make_mosr as jax_make_mosr
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_mosr
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 5e-4


def _sd(upsampler='ps', upscale=2, seed=0):
    return strong(make_mosr(16, 2, upscale, seed=seed, upsampler=upsampler), seed)


def _x(h, w, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('upsampler,upscale', [('ps', 2), ('dys', 2), ('gps', 4), ('ps', 4), ('dys', 4), ('gps', 2),
                                               ('ps', 3)])
def test_mosr_matches_jax(upsampler, upscale):
    tm, _ = both(_sd(upsampler, upscale, seed=upscale), _x(11, 13), 'MoSR', TOL)
    assert tm.metadata == ModelMetadata(3, 3, upscale, 'MoSR')
    cfg = tm.config
    assert (cfg.upsampler, cfg.n_block, cfg.dim, cfg.expansion_ratio, cfg.conv_ratio, cfg.kernel_size) == (
        upsampler, 2, 16, 1.5, 1.0, 7)


def test_zoo_make_mosr_is_the_jax_one():
    a, b = make_mosr(16, 2, 4, seed=4), jax_make_mosr(16, 2, 4, seed=4)
    assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_mosr_4x_routes_its_54_convs(monkeypatch):
    """``mosr 4x`` (24 blocks, dim 64, ``ps``): the stem; per block fc1 64
    -> 192 (linear) and fc2 96 -> 64 (Mish); the tail's 64 -> 128 and 128
    -> 64 (Mish); the shortcut's 3 -> 64 and 64 -> 64 (Mish); the 64 -> 48
    head."""
    tm = resselt_tpu_torch.load_from_state_dict(make_mosr(64, 24, 4), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    assert calls.calls == ([(3, 64, 'linear')] + [(64, 192, 'linear'), (96, 64, 'mish')] * 24
                           + [(64, 128, 'mish'), (128, 64, 'mish'), (3, 64, 'mish'), (64, 64, 'mish'),
                              (64, 48, 'linear')])


def test_depthwise_conv_stays_plain():
    tm = resselt_tpu_torch.load_from_state_dict(_sd(), device='cpu')
    w = tm.weights(torch.float32)
    assert not w['gblocks.1.conv'].kernel and w['gblocks.1.conv'].groups == 16 and w['gblocks.1.conv'].padding == (3, 3)
    assert w['gblocks.1.fc1'].kernel and not w['gblocks.7'].kernel  # the tail's 1x1


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd('gps', 2, seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd('dys', seed=8), extra) == (60, 76, 3)
