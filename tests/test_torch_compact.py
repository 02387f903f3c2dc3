"""The port's Compact (SRVGGNetCompact) against resselt_tpu on the same
state dicts (``zoo.make_compact``), on the CPU in f32, with
test_conv_archs.py's TOL (5e-4): test_conv_archs.py's variants (24
features, 4 convs, upscale 1 / 2 / 4 on its 17x23 input) with weights of
order one; config, metadata and serving hint equal; the zoo's builder equal
to JAX's; ``compact 4x``'s layout and its 18 routed convs; the weights
packed once per dtype; params carried across from a JAX model; tiled and
CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu.zoo import make_compact as jax_make_compact
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_compact
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 5e-4


def _sd(upscale=2, seed=0):
    return strong(make_compact(24, 4, upscale, seed=seed), seed)


def _x(h, w, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('upscale', [1, 2, 4])
def test_compact_matches_jax(upscale):
    tm, _ = both(_sd(upscale, seed=upscale), _x(17, 23), 'Compact', TOL)
    assert tm.metadata == ModelMetadata(3, 3, upscale, 'Compact')
    assert (tm.config.num_feat, tm.config.num_conv, tm.serving_halo) == (24, 4, 4)


def test_zoo_make_compact_is_the_jax_one():
    a, b = make_compact(16, 3, 2, seed=4), jax_make_compact(16, 3, 2, seed=4)
    assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_compact_4x_routes_its_18_convs(monkeypatch):
    """``compact 4x`` (64 features, 16 convs): every conv is a 3x3 with act
    linear (the PReLU runs after it), 3 -> 64, 16 x 64 -> 64, 64 -> 48."""
    sd = make_compact()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert (tm.config.num_feat, tm.config.num_conv, tm.config.upscale) == (64, 16, 4)
    calls = RoutedCalls(monkeypatch)
    y = tm(_x(8, 10))
    assert y.shape == (1, 32, 40, 3)
    assert calls.calls == [(3, 64, 'linear')] + [(64, 64, 'linear')] * 16 + [(64, 48, 'linear')]


def test_prepare_packs_once_per_dtype():
    tm = resselt_tpu_torch.load_from_state_dict(_sd(), device='cpu')
    w32 = tm.weights(torch.float32)
    assert tm.weights(torch.float32) is w32
    wb = tm.weights(torch.bfloat16)
    assert wb['body.2'].kernel and wb['body.2'].w.shape == (9, 24, 24) and wb['body.2'].w.dtype == torch.bfloat16
    assert 'body.2.weight' not in wb and wb['body.1.weight'].dtype == torch.bfloat16
    yb = tm(_x(9, 11), dtype=torch.bfloat16)
    mse = float(((yb.float() - tm(_x(9, 11))) ** 2).mean())
    assert yb.dtype == torch.bfloat16 and 10 * np.log10(1.0 / max(mse, 1e-12)) > 35


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(seed=8), extra) == (60, 76, 3)
