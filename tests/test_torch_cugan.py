"""The port's CUGAN against resselt_tpu on the same state dicts
(``zoo.make_cugan``, at UpCunet's fixed widths), on the CPU in f32, with
test_cugan.py's TOL (5e-4): the four variants (2x, 3x, 4x, 2x_fast), each
with and without ``pro``, on test_cugan.py's inputs (21 x 27; 43 x 47 for
2x_fast) and on inputs smaller than the reflect halo; ``pad2d``'s reflect
and crops against the JAX package's; no conv routed to the 3x3 kernel;
params carried across from a JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

from resselt_tpu.nn import functional as JF
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.nn import functional as F
from resselt_tpu_torch.zoo import make_cugan
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 5e-4
_SCALE = {'2x': 2, '3x': 3, '4x': 4, '2x_fast': 2}


def _sd(variant='2x', pro=False, seed=0):
    return strong(make_cugan(variant, pro, seed=seed), seed)


def _x(h, w, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('pro', [False, True], ids=['plain', 'pro'])
@pytest.mark.parametrize('variant', ['2x', '3x', '4x', '2x_fast'])
def test_cugan_matches_jax(variant, pro):
    hw = (43, 47) if variant == '2x_fast' else (21, 27)
    tm, _ = both(_sd(variant, pro, seed=len(variant)), _x(*hw), 'CuGAN', TOL)
    assert tm.metadata == ModelMetadata(3, 3, _SCALE[variant], 'CUGAN')
    assert (tm.config.variant, tm.config.pro) == (variant, pro)
    assert 'pro' not in tm.params


@pytest.mark.parametrize('variant,hw', [('2x', (5, 7)), ('3x', (4, 3)), ('4x', (6, 2)), ('2x_fast', (11, 15))])
def test_input_smaller_than_the_halo(variant, hw):
    """The reflect halo (18 / 14 / 19 / 38) is longer than the input: both
    packages reflect periodically, as ``jnp.pad`` does."""
    tm, _ = both(_sd(variant, seed=3), _x(*hw, seed=1), 'CuGAN', TOL)
    assert tm(_x(*hw, seed=1)).shape == (1, hw[0] * _SCALE[variant], hw[1] * _SCALE[variant], 3)


@pytest.mark.parametrize('pads', [(18, 20, 18, 19), (5, 0, 0, 9), (-4, -4, -4, -4), (-1, 3, 2, -2), (0, 0, 0, 0)])
@pytest.mark.parametrize('mode', ['reflect', 'constant', 'replicate'])
def test_pad2d_matches_jax(mode, pads):
    x = np.random.default_rng(2).standard_normal((2, 12, 11, 3)).astype(np.float32)
    want = np.asarray(JF.pad2d(x, pads, mode))
    np.testing.assert_array_equal(F.pad2d(torch.from_numpy(x), pads, mode).numpy(), want)


def test_cugan_routes_no_conv(monkeypatch):
    """Every conv of CUGAN is unpadded, strided or transposed: none reaches
    the 3x3 kernel, and the model has no ``prepare``."""
    import resselt_tpu_torch

    tm = resselt_tpu_torch.load_from_state_dict(make_cugan('2x'), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 16, 20, 3)
    assert calls.calls == [] and tm.weights(torch.float32) is tm.params


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd('4x', True, seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd('2x', True, seed=8), extra) == (60, 76, 3)
