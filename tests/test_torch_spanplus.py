"""The port's SPANPlus against resselt_tpu on the same state dicts
(``zoo.make_spanplus``), on the CPU in f32, with test_spanplus.py's TOL
(2e-4): its four upsampler / scale variants (``ps`` 2x and 4x, ``dys``
2x, ``conv`` 1x; 16 features, blocks (2,), on its 24x20 input) and its
multi-group (2, 3) model on a batch of two, with weights of order one;
config and metadata equal; the zoo's ``ps`` builder equal to JAX's;
``spanplus 2x``'s 21 routed convs with c1's and c2's Mish fused; params
carried across from a JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu.zoo import make_spanplus as jax_make_spanplus
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_spanplus
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 2e-4


def _sd(upsampler='ps', upscale=2, blocks=(2,), seed=0):
    return strong(make_spanplus(16, blocks, upscale, seed=seed, upsampler=upsampler), seed)


def _x(h, w, n=1, seed=7):
    return np.random.default_rng(seed).random((n, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('upsampler,upscale', [('ps', 2), ('ps', 4), ('dys', 2), ('conv', 1)])
def test_spanplus_matches_jax(upsampler, upscale):
    tm, _ = both(_sd(upsampler, upscale, seed=upscale), _x(24, 20), 'spanplus', TOL)
    assert tm.metadata == ModelMetadata(3, 3, upscale, 'SPANPlus')
    assert (tm.config.upsampler, tm.config.blocks, tm.config.feature_channels) == (upsampler, (2,), 16)


def test_spanplus_multiblock_matches_jax():
    tm, _ = both(_sd(blocks=(2, 3), seed=1), _x(16, 16, n=2, seed=1), 'spanplus', TOL)
    assert tm.config.blocks == (2, 3)


def test_zoo_make_spanplus_is_the_jax_one():
    a, b = make_spanplus(16, (1, 2), 2, seed=4), jax_make_spanplus(16, (1, 2), 2, seed=4)
    assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_spanplus_2x_routes_its_21_convs(monkeypatch):
    """``spanplus 2x`` (blocks (4,), 48 features, ``ps``): the stem, six
    SPABs of three convs (c1 and c2 with Mish), ``conv_2`` and the 48 -> 12
    head."""
    tm = resselt_tpu_torch.load_from_state_dict(make_spanplus(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 16, 20, 3)
    spab = [(48, 48, 'mish'), (48, 48, 'mish'), (48, 48, 'linear')]
    assert calls.calls == [(3, 48, 'linear')] + spab * 6 + [(48, 48, 'linear'), (48, 12, 'linear')]


@pytest.mark.parametrize('upsampler,upscale,routed', [('dys', 2, 14), ('conv', 1, 15)])
def test_other_tails_route_their_3x3(monkeypatch, upsampler, upscale, routed):
    """DySample's convs are 1x1 and stay F.conv2d; the ``conv`` tail is a
    routed 3x3 (blocks (2,): the stem, 4 x 3, ``conv_2``)."""
    tm = resselt_tpu_torch.load_from_state_dict(_sd(upsampler, upscale), device='cpu')
    calls = RoutedCalls(monkeypatch)
    tm(_x(8, 10))
    assert len(calls.calls) == routed


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd('dys', seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(seed=8), extra) == (60, 76, 3)
