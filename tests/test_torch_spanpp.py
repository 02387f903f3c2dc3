"""The port's SpanPP against resselt_tpu on the same state dicts
(``zoo.make_spanpp``), on the CPU in f32, with test_spanpp.py's TOL
(5e-4): test_spanpp.py's widths (16 features, scales (1, 2, 3, 4), a 3x3
IGConv, implicit dim 32, two latent layers) on its 14x18 input at the
default scale 2 and at every ``eval_scale`` through ``with_config``; a
checkpoint with its own scale list (``MetaIGConv``) and a 5x5 IGConv;
config and metadata (the scale list) equal; the synthesized IGConv kernels
equal JAX's; the zoo's SpanPP layout and its 21 routed convs at each
scale; params carried across from a JAX model; tiled output of a
``with_config`` model against JAX's; the CLI with and without ``--scale``,
whole and tiled."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu_torch
from resselt_tpu.archs import spanpp as jspanpp
from resselt_tpu_torch.archs import spanpp
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_spanpp
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both


torch.set_num_threads(2)

TOL = 5e-4


def _sd(seed=0, **kw):
    kw = {'implicit_dim': 32, 'latent_layers': 2, **kw}
    return make_spanpp(16, seed=seed, **kw)


def _x(h=14, w=18, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


def test_spanpp_matches_jax():
    tm, _ = both(_sd(), _x(), 'SpanPP', TOL)
    assert tm.metadata == ModelMetadata(3, 3, [1, 2, 3, 4], 'SpanPP')
    cfg = tm.config
    assert (cfg.eval_scale, cfg.ig_kernel, cfg.implicit_dim, cfg.latent_layers) == (2, 3, 32, 2)
    assert not any(k.startswith(('upsampler.freq', 'upsampler.query_kernel')) or '.conv1.' in k for k in tm.params)


@pytest.mark.parametrize('scale', [1, 2, 3, 4])
def test_spanpp_every_eval_scale_matches_jax(scale):
    sd = _sd(seed=scale)
    x = _x(seed=4)
    jm = resselt_tpu.load_from_state_dict(sd).with_config(eval_scale=scale)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu').with_config(eval_scale=scale)
    assert tm.metadata.upscale == jm.metadata.upscale == scale
    want = np.asarray(jm(x))
    got = tm(x).numpy()
    assert got.shape == want.shape == (1, 14 * scale, 18 * scale, 3)
    assert float(np.abs(got - want).max()) < TOL


@pytest.mark.parametrize('kw', [{'scale_list': (2, 3)}, {'ig_kernel': 5}, {'latent_layers': 1}],
                         ids=['meta_scales', 'ig_kernel_5', 'one_latent_layer'])
def test_spanpp_variants_match_jax(kw):
    tm, _ = both(_sd(seed=5, **kw), _x(), 'SpanPP', TOL)
    assert tm.config.scale_list == tuple(kw.get('scale_list', (1, 2, 3, 4)))
    assert tm.weights(torch.float32)['upsampler.eval_convs.2'].kernel is (kw.get('ig_kernel', 3) == 3)


def test_synthesized_kernels_equal_jax():
    sd = _sd(seed=6)
    for s in (1, 2, 3, 4):
        np.testing.assert_array_equal(spanpp.synthesize_igconv_kernel(sd, s, 16, 3, 32, 2, 4),
                                      jspanpp.synthesize_igconv_kernel(sd, s, 16, 3, 32, 2, 4))
    np.testing.assert_array_equal(spanpp._make_coord(3), jspanpp._make_coord(3))


@pytest.mark.parametrize('scale', [1, 2, 3, 4])
def test_zoo_spanpp_routes_its_21_convs(monkeypatch, scale):
    """The zoo's SpanPP (48 features, 3x3 IGConv): the stem, six SPABs of
    three (c1 and c2 with SiLU), ``conv_2`` and the 48 -> 3 s² eval conv."""
    sd = make_spanpp()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu').with_config(eval_scale=scale)
    cfg = tm.config
    assert (cfg.feature_channels, cfg.scale_list, cfg.ig_kernel, cfg.implicit_dim, cfg.latent_layers) == (
        48, (1, 2, 3, 4), 3, 256, 4)
    assert tm.config.__dict__ == resselt_tpu.load_from_state_dict(sd).with_config(eval_scale=scale).config.__dict__
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 8 * scale, 10 * scale, 3)
    spab = [(48, 48, 'silu'), (48, 48, 'silu'), (48, 48, 'linear')]
    assert calls.calls == [(3, 48, 'linear')] + spab * 6 + [(48, 48, 'linear'), (48, 3 * scale * scale, 'linear')]


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(seed=7), _x(9, 12), TOL)


def test_tiled_matches_jax():
    """The tiled driver needs an integer scale: a ``with_config`` model."""
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    got = tiled_both(_sd(seed=8), img, tile=16, halo=4, tol=TOL, overrides={'eval_scale': 3})
    assert got.shape == (120, 138, 3)


@pytest.mark.parametrize('extra,shape', [([], (60, 76, 3)), (['--scale', '3'], (90, 114, 3)),
                                         (['--scale', '4', '--tile', '16'], (120, 152, 3)),
                                         (['--scale', '1', '--tile', '16'], (30, 38, 3))],
                         ids=['whole', 'scale3', 'scale4_tiled', 'scale1_tiled'])
def test_cli_matches_jax(tmp_path, extra, shape):
    assert cli_both(tmp_path, _sd(seed=9), extra) == shape
