"""The port's SPAN against resselt_tpu on the same state dicts
(``zoo.make_span``), on the CPU in f32, with test_conv_archs.py's TOL
(5e-4): with and without the input normalization (the ``no_norm`` buffer),
test_conv_archs.py's 16 features at 2x on its 16x18 input, and 4x, with
weights of order one; config, metadata and serving hint equal; the zoo's
builder equal to JAX's; ``span 4x``'s 21 routed convs with c1's and c2's
SiLU fused; params carried across from a JAX model; tiled and CLI
output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu.zoo import make_span as jax_make_span
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_span
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 5e-4


def _sd(norm=True, upscale=2, seed=0):
    return strong(make_span(16, upscale, seed=seed, norm=norm), seed)


def _x(h, w, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('norm,upscale', [(True, 2), (False, 2), (True, 4), (False, 4)])
def test_span_matches_jax(norm, upscale):
    tm, _ = both(_sd(norm, upscale, seed=upscale), _x(16, 18), 'SPAN', TOL)
    assert tm.metadata == ModelMetadata(3, 3, upscale, 'SPAN')
    assert (tm.config.norm, tm.config.feature_channels, tm.serving_halo) == (norm, 16, 4)
    assert 'no_norm' not in tm.params and not any('.sk.' in k or '.conv.' in k for k in tm.params)


def test_zoo_make_span_is_the_jax_one():
    a, b = make_span(16, 2, seed=4), jax_make_span(16, 2, seed=4)
    assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_span_4x_routes_its_21_convs(monkeypatch):
    """``span 4x`` (48 features): the stem, three convs in each of six
    SPABs (c1 and c2 with SiLU), ``conv_2`` and the 48 -> 48 pixel-shuffle
    head; ``conv_cat`` (1x1) stays F.conv2d."""
    tm = resselt_tpu_torch.load_from_state_dict(make_span(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    spab = [(48, 48, 'silu'), (48, 48, 'silu'), (48, 48, 'linear')]
    assert calls.calls == [(3, 48, 'linear')] + spab * 6 + [(48, 48, 'linear'), (48, 48, 'linear')]


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    # without norm: the reference's unnormalized output stays near the image's range
    assert tiled_both(_sd(False, seed=6), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(False, seed=8), extra) == (60, 76, 3)
