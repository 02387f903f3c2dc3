"""The port's GateR against resselt_tpu on the same state dicts
(``zoo.make_gater``), on the CPU in f32, with test_gater.py's TOL (1e-3):
with the 7x7 depthwise latent and with FLPVT2 attention in the latent, at
test_gater.py's widths (dim 16, blocks (1, 1, 1, 2, 1, 1, 1)) on its 21 x
26 input, with weights of order one; ``F.rms_norm`` against the JAX
package's; the zoo's builder equal to JAX's; the routed convs; params
carried across from a JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu.nn import functional as JF
from resselt_tpu.zoo import make_gater as jax_make_gater
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.nn import functional as F
from resselt_tpu_torch.zoo import make_gater
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3
_BLOCKS = (1, 1, 1, 2, 1, 1, 1)


def _sd(latent_att=False, seed=0):
    return strong(make_gater(16, _BLOCKS, seed=seed, latent_att=latent_att), seed)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('latent_att', [False, True])
def test_gater_matches_jax(latent_att):
    tm, _ = both(_sd(latent_att, seed=1), _x(21, 26), 'GateR', TOL)
    assert tm.metadata == ModelMetadata(3, 3, 1, 'GateR')
    assert (tm.config.latent_att, tm.config.num_blocks, tm.config.dim) == (latent_att, _BLOCKS, 16)


@pytest.mark.parametrize('offset', [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)
    w = rng.standard_normal(12).astype(np.float32)
    want = np.asarray(JF.rms_norm(x, w, offset=offset))
    np.testing.assert_allclose(F.rms_norm(torch.from_numpy(x), torch.from_numpy(w), offset).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(JF.rms_norm_ref(x, w, w[::-1] * 0.1))
    np.testing.assert_allclose(F.rms_norm_ref(torch.from_numpy(x), torch.from_numpy(w),
                                              torch.from_numpy(w[::-1].copy() * 0.1)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_zoo_make_gater_is_the_jax_one():
    a, b = make_gater(16, _BLOCKS, seed=4), jax_make_gater(16, _BLOCKS, seed=4)
    assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_gater_routes_its_3x3_convs(monkeypatch):
    """``in_to_dim``, the six ``body.0`` stage convs and ``dim_to_ch.*`` are
    routed (linear); the depthwise token mixers, FLPVT2's ``dwc``, the 1x1
    ``dec*.0`` and the linears are not."""
    tm = resselt_tpu_torch.load_from_state_dict(make_gater(16, _BLOCKS, latent_att=True), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(16, 24)).shape == (1, 16, 24, 3)
    assert calls.calls == [(3, 16, 'linear'), (16, 8, 'linear'), (32, 16, 'linear'), (64, 32, 'linear'),
                           (128, 256, 'linear'), (64, 128, 'linear'), (32, 64, 'linear'), (32, 16, 'linear'),
                           (16, 3, 'linear')]
    w = tm.weights(torch.float32)
    assert not w['enc0.gated.0.conv.conv'].kernel and w['enc0.gated.0.conv.conv'].groups == 16
    assert not w['latent.1.gated.0.conv.dwc'].kernel and w['latent.1.gated.0.conv.dwc'].groups == 16


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(True, seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (40, 46, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(True, seed=8), extra) == (30, 38, 3)
