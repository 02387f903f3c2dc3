"""The port's GateRv2 against resselt_tpu on the same state dicts
(``zoo.make_gaterv2``), on the CPU in f32, with test_gaterv2.py's TOL
(1e-3): the 1x restoration model and SR models with their MetaUpsample
buffer (pixelshuffledirect, dysample), at test_gaterv2.py's widths (dim 16,
enc and dec blocks (1, 1)), with weights of order one; the JAX package's
fixes kept (the probed MetaUpsample key is read, the crop uses the real
scale); the routed convs; params carried across from a JAX model; tiled and
CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_gaterv2
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _sd(scale=1, upsampler='pixelshuffledirect', num_latent=2, seed=0):
    return strong(make_gaterv2(16, (1, 1), (1, 1), num_latent, scale, upsampler=upsampler, upsample_mid_dim=16,
                               seed=seed), seed)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('scale,upsampler,hw', [(1, 'conv', (13, 18)), (2, 'pixelshuffledirect', (12, 16)),
                                                (2, 'dysample', (13, 18))])
def test_gaterv2_matches_jax(scale, upsampler, hw):
    tm, _ = both(_sd(scale, upsampler, seed=scale), _x(*hw), 'GateRv2', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'GateRv2')
    assert tm(_x(*hw)).shape == (1, hw[0] * scale, hw[1] * scale, 3)  # cropped with the real scale
    assert (tm.config.enc_blocks, tm.config.dec_blocks, tm.config.upsampler) == ((1, 1), (1, 1), upsampler)
    assert 'upsample.MetaUpsample' not in tm.params


def test_gaterv2_routes_its_3x3_convs(monkeypatch):
    """The bench configuration (dim 32, enc (2, 2, 4), dec (4, 2, 2), 6
    latent blocks, 1x): ``in_to_dim``, the six bias-free ``scale.0`` and
    ``dim_to_in``; every gated block's convs are 1x1 or grouped, and
    ``local.2`` keeps groups = its block's width."""
    tm = resselt_tpu_torch.load_from_state_dict(make_gaterv2(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 16)).shape == (1, 8, 16, 3)
    assert calls.calls == [(3, 32, 'linear'), (32, 16, 'linear'), (64, 32, 'linear'), (128, 64, 'linear'),
                           (256, 512, 'linear'), (128, 256, 'linear'), (64, 128, 'linear'), (32, 3, 'linear')]
    w = tm.weights(torch.float32)
    assert [w[f'encode.{i}.gated.0.local.2'].groups for i in (0, 1, 2)] == [32, 64, 128]
    assert w['decode.0.gated.0.local.2'].groups == 128 and not w['decode.0.gated.0.local.2'].kernel


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(2, seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (40, 46, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(2, seed=8), extra) == (60, 76, 3)
