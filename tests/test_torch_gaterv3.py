"""The port's GateRV3 against resselt_tpu on the same state dicts
(``zoo.make_gaterv3``), on the CPU in f32, with test_gaterv3.py's TOL
(1e-3): test_gaterv3.py's cases (1x; 2x with the channel attention; 2x
dysample with a 3x3 end conv; pa_up at 2x and 4x) and the other tails
(lda, transpose+conv at 3x, no ``gamma``), at its widths (dim 16, enc and
dec blocks (1, 1), one latent block, one SPAB) on its 13 x 18 input, with
weights of order one; the bias-free Conv3XC collapse equal in both
packages; the routed convs; params carried across from a JAX model; tiled
and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu_torch
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_gaterv3
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _sd(scale=1, attention=False, upsampler='pixelshuffledirect', end_kernel=1, gamma=True, seed=0):
    return strong(make_gaterv3(16, (1, 1), (1, 1), 1, scale, upsampler=upsampler, upsample_mid_dim=16,
                               attention=attention, span_blocks=1, end_kernel=end_kernel, gamma=gamma,
                               seed=seed), seed)


def _x(h=13, w=18, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('scale,attention,upsampler,end_kernel,gamma', [
    (1, False, 'conv', 1, True),
    (2, True, 'pixelshuffledirect', 1, True),
    (2, False, 'dysample', 3, True),
    (2, False, 'pa_up', 1, True),
    (4, False, 'pa_up', 1, False),
    (2, True, 'lda', 1, True),
    (3, False, 'transpose+conv', 1, True),
])
def test_gaterv3_matches_jax(scale, attention, upsampler, end_kernel, gamma):
    tm, _ = both(_sd(scale, attention, upsampler, end_kernel, gamma, seed=scale), _x(), 'GateRV3', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'GateRV3')
    cfg = tm.config
    assert (cfg.attention, cfg.upsampler, cfg.end_kernel, cfg.span_blocks) == (
        attention, upsampler if scale != 1 else 'conv', end_kernel, 1)
    assert torch.equal(tm.params['gamma'] == 1, torch.full((1, 3, 1, 1), not gamma))


def test_collapsed_params_equal_jax():
    """``collapse_all`` with the ``sk.weight`` marker gives the bias-free
    SPAB convs and the biased ``sisr_end_conv`` the same arrays in both
    packages."""
    sd = _sd(2, False, 'pa_up', seed=4)
    jp = resselt_tpu.load_from_state_dict(sd).params
    tp = resselt_tpu_torch.load_from_state_dict(sd, device='cpu').params
    assert set(jp) == set(tp)
    assert 'span_block0.c1_r.eval_conv.bias' not in tp and 'sisr_end_conv.eval_conv.bias' in tp
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_gaterv3_routes_its_3x3_convs(monkeypatch):
    """The bench configuration (dim 32, enc (2, 2, 4), dec (4, 2, 2), four
    latent blocks with attention, 4 SPABs, 1x): ``in_to_dim``; six SPABs
    with the SiLU after c1 and c2 fused; ``sisr_end_conv``; the six
    ``scale.0``; ``dim_to_in``.  ``qkv_dwconv`` keeps groups 3c."""
    tm = resselt_tpu_torch.load_from_state_dict(make_gaterv3(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 16)).shape == (1, 8, 16, 3)
    spab = [(32, 32, 'silu'), (32, 32, 'silu'), (32, 32, 'linear')]
    unet = [(32, 16, 'linear'), (64, 32, 'linear'), (128, 64, 'linear'), (256, 512, 'linear'), (128, 256, 'linear'),
            (64, 128, 'linear')]
    assert calls.calls == [(3, 32, 'linear')] + spab * 6 + [(32, 32, 'linear')] + unet + [(32, 3, 'linear')]
    w = tm.weights(torch.float32)
    assert w['latent.0.token_mix.qkv_dwconv'].groups == 768


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(2, True, seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (40, 46, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(2, False, 'dysample', 3, seed=8), extra) == (60, 76, 3)
