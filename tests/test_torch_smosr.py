"""The port's SMoSR against resselt_tpu on the same state dicts
(``zoo.make_smosr``), on the CPU in f32, with test_smosr.py's TOL (1e-3):
test_smosr.py's variants (DOConv and ConvNXC bundles, pixelshuffledirect,
pa_up 4x, DySample behind a leading conv and without one) at its widths
(dim 16, two middle blocks, a 3x3 DySample end conv) on its inputs, the
other tails, with weights of order one; the stale nested ``eval_conv``
buffers of a ``rep`` checkpoint dropped; the routed convs of the bench
configuration; params carried across from a JAX model; tiled and CLI
output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_smosr
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _sd(rep=False, upsampler='pixelshuffledirect', scale=2, mid_dim=8, seed=0):
    """test_smosr.py's model, weights of order one and DOConv ``mul``s of
    one (so that every bundle passes its input on at its own scale)."""
    sd = strong(make_smosr(16, 2, scale, rep=rep, upsampler=upsampler, mid_dim=mid_dim, seed=seed), seed)
    return {k: np.ones_like(v) if k.endswith('.mul') else v for k, v in sd.items()}


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('rep,upsampler,scale', [
    (False, 'pixelshuffledirect', 2), (True, 'pixelshuffledirect', 2), (False, 'pa_up', 4), (False, 'dysample', 2),
    (True, 'pixelshuffle', 4), (False, 'nearest+conv', 3), (False, 'conv', 1), (True, 'pa_up', 3),
])
def test_smosr_matches_jax(rep, upsampler, scale):
    tm, _ = both(_sd(rep, upsampler, scale, seed=scale), _x(14, 18), 'SMoSR', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'SMoSR')
    assert (tm.config.rep, tm.config.upsampler, tm.config.dim, tm.config.n_mb) == (rep, upsampler, 16, 2)
    assert 'upsampler.MetaUpsample' not in tm.params


def test_smosr_dysample_without_leading_conv():
    """mid_dim equal to the upsampler's input width puts DySample at
    ``upsampler.0``; its 3x3 end conv is read there (a 1x1 fallback would
    crop the output wrong)."""
    sd = _sd(upsampler='dysample', mid_dim=16 + 12, seed=4)
    assert 'upsampler.0.end_conv.weight' in sd and 'upsampler.2.end_conv.weight' not in sd
    tm, _ = both(sd, _x(12, 14, seed=4), 'SMoSR', TOL)
    assert tm.config.d_kernel == 3
    assert tm(_x(12, 14)).shape == (1, 24, 28, 3)


def test_smosr_rep_drops_stale_nested_eval_convs():
    """A ``rep`` checkpoint's nested ``eval_conv`` buffers (inside each
    collapsed ConvNXC's DOConvs) are not loaded: only the collapsed
    ``{bundle}.eval_conv`` weights stay."""
    sd = _sd(rep=True, seed=5)
    assert any('.conv.1.eval_conv.' in k for k in sd)
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    assert not [k for k in tm.params if k.count('.eval_conv.') > 1 or '.sk.' in k or k.endswith(('.W', '.D', '.mul'))
                or any(f'.conv.{i}.eval_conv.' in k for i in range(3))]
    assert sum(v.numel() for v in tm.params.values()) < sum(v.size for v in sd.values()) / 3


def test_smosr_4x_routes_its_12_convs(monkeypatch):
    """The bench configuration (dim 64, two middle blocks, 4x
    pixelshuffledirect): per SMB ``body.0`` and ``body.2`` with their SiLU
    (the first from 3 channels), ``end_block.1`` and the 112 -> 48 head;
    the 1x1 convs stay plain."""
    tm = resselt_tpu_torch.load_from_state_dict(make_smosr(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    assert calls.calls == ([(3, 64, 'silu'), (64, 64, 'silu')] + [(64, 64, 'silu')] * 8
                           + [(64, 64, 'linear'), (112, 48, 'linear')])


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(True, 'dysample', seed=6), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=7), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(upsampler='pa_up', scale=2, seed=8), extra) == (60, 76, 3)
