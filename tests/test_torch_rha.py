"""The port's RHA against resselt_tpu on the same state dicts
(``zoo.make_rha``), on the CPU in f32, with test_rha.py's TOL (1e-3):
test_rha.py's (scale, unshuffle, down list, upsampler) variants at its
widths (dim 16, two blocks a group, window 4) on a 10x13 input, which is not
aligned (the JAX package crops an unshuffle checkpoint's output to the true
scale), and a DySample 3x; weights of order one; the focused linear
attention in 16-bit; the routed convs of the bench configuration; params
carried across from a JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.archs import rha
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.nn.params import PTree
from resselt_tpu_torch.zoo import make_rha
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _sd(scale=2, unshuffle=False, down=(2, 1), upsample='pixelshuffledirect', seed=0):
    return strong(make_rha(16, scale, mid_dim=16, down_list=down, res_blocks=2, upsample=upsample,
                           unshuffle_mod=unshuffle, window_size=4, head_dim=4, dwc_kernel=3, seed=seed), seed)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('scale,unshuffle,down,upsample', [
    (2, False, (2, 1), 'pixelshuffledirect'), (4, False, (2,), 'pixelshuffle'), (2, True, (1,), 'pixelshuffledirect'),
    (3, False, (1, 2), 'dysample'),
])
def test_rha_matches_jax(scale, unshuffle, down, upsample):
    tm, _ = both(_sd(scale, unshuffle, down, upsample, seed=scale), _x(10, 13), 'RHA', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'RHA')
    assert (tm.config.down_list, tm.config.unshuffle_mod, tm.config.window_size) == (down, unshuffle, 4)
    assert not any(k.endswith(('down_sample', 'unshuffle', 'MetaUpsample', '.alpha1')) for k in tm.params)


@pytest.mark.parametrize('dtype', [torch.float16, torch.bfloat16])
def test_focused_attention_keeps_16_bit_finite(dtype):
    """The focusing (``q ** 3`` of softplus-scaled activations) and its
    norms run in f32: with 16-bit inputs of the size a trained block sees,
    the attention stays finite and near its f32 value."""
    params = {k: torch.from_numpy(v) for k, v in strong(make_rha(32, 2, down_list=(1,), res_blocks=1, window_size=8,
                                                                 head_dim=8, seed=1), 1, gain=2.0).items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, 16, 16)).astype(np.float32) * 30)

    def fla(t):
        return rha._fla(PTree(rha.prepare(None, params, t.dtype)).sub('body.0.body.0.conv.att.2'), t, 8).float()

    want, got = fla(x), fla(x.to(dtype))
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < 0.05 * float(want.abs().max())


def test_rha_4x_routes_its_53_convs(monkeypatch):
    """The bench configuration (dim 64, four groups of six blocks, 4x
    pixelshuffle): the stem, per block fc1 64 -> 192 and fc2 96 -> 64
    (Mish), the tail's 64 -> 64, two 64 -> 256 and 64 -> 3; the OmniShifts,
    the 1x1 convs, ``dwc`` and the attention stay plain."""
    tm = resselt_tpu_torch.load_from_state_dict(make_rha(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    assert calls.calls == ([(3, 64, 'linear')] + [(64, 192, 'linear'), (96, 64, 'mish')] * 24
                           + [(64, 64, 'linear'), (64, 256, 'linear'), (64, 256, 'linear'), (64, 3, 'linear')])


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(2, True, (1,), seed=8), extra) == (60, 76, 3)
