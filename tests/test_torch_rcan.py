"""The port's RCAN against resselt_tpu on the same state dicts
(``zoo.make_rcan``), on the CPU in f32, with test_rcan_eimn.py's TOL
(5e-4): its five scale x norm x unshuffle variants (2 groups of 2 RCABs, 16
features, reduction 4, on its 11x13 input: the unshuffle head's reflect pad
and the crop) and a 5x5 model, with weights of order one and the
MeanShifts kept; config and metadata equal; the published RCAN's layout and
its 415 routed convs; the 5x5 model's routed 3x3 tail; params carried
across from a JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu
import resselt_tpu_torch
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_rcan
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 5e-4


def _sd(scale=2, norm=True, unshuffle=False, kernel_size=3, seed=0):
    sd = make_rcan(16, 2, 2, 4, scale, norm, unshuffle, kernel_size, seed=seed)
    out = strong(sd, seed)
    out.update({k: v for k, v in sd.items() if k.startswith(('sub_mean', 'add_mean'))})
    return out


def _x(h=11, w=13, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('scale,norm,unshuffle', [
    (2, True, False), (4, False, False), (3, True, False), (2, True, True), (1, False, True),
])
def test_rcan_matches_jax(scale, norm, unshuffle):
    tm, _ = both(_sd(scale, norm, unshuffle, seed=scale), _x(), 'RCAN', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'RCAN')
    cfg = tm.config
    assert (cfg.scale, cfg.norm, cfg.unshuffle_mod, cfg.rgb_range, cfg.reduction) == (
        scale, norm, unshuffle, 255 if norm else 1, 4)


def test_rcan_kernel_5_routes_only_its_3x3_tail(monkeypatch):
    sd = _sd(4, kernel_size=5, seed=1)
    tm, _ = both(sd, _x(), 'RCAN', TOL)
    assert tm.config.kernel_size == 5
    calls = RoutedCalls(monkeypatch)
    tm(_x())
    assert calls.calls == [(16, 64, 'linear')] * 2


def test_published_rcan_routes_its_415_convs(monkeypatch):
    """The published RCAN 4x (10 groups of 20 RCABs, 64 features, reduction
    16, MeanShifts): the head, two convs per RCAB, each group's and the
    body's closing conv, the two 64 -> 256 tail convs and 64 -> 3; ReLU,
    the channel attention and the MeanShifts stay plain torch."""
    sd = make_rcan()
    tm = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    cfg = tm.config
    assert cfg.__dict__ == resselt_tpu.load_from_state_dict(sd).config.__dict__
    assert (cfg.n_resgroups, cfg.n_resblocks, cfg.n_feats, cfg.reduction, cfg.norm, cfg.scale) == (
        10, 20, 64, 16, True, 4)
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 6)).shape == (1, 32, 24, 3)
    assert calls.calls == ([(3, 64, 'linear')] + ([(64, 64, 'linear')] * 41) * 10 + [(64, 64, 'linear')]
                           + [(64, 256, 'linear')] * 2 + [(64, 3, 'linear')])
    assert len(calls.calls) == 415


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(2, True, True, seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(2, True, True, seed=8), extra) == (60, 76, 3)
