"""The port's RTMoSR against resselt_tpu on the same state dicts
(``zoo.make_rtmosr``), on the CPU in f32, with test_mosr_family.py's TOL
(5e-4): test_mosr_family.py's (scale, unshuffle, dccm, se) variants at its
widths (dim 16, ffn 2, two blocks) on an 11x13 input (the pad to a
multiple of 2 or of the unshuffle factor and the crop run), with weights
of order one; the collapsed RepConv / OmniShift params, the true scale in
the metadata; the routed convs of the bench configuration; params carried
across from a JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_rtmosr
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 5e-4


def _sd(scale=2, unshuffle=False, dccm=True, se=True, seed=0):
    return strong(make_rtmosr(16, 2, scale, 2.0, unshuffle, dccm, se, se_reduction=4, seed=seed), seed)


def _x(h, w, seed=0):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('scale,unshuffle,dccm,se', [
    (2, False, True, True), (2, True, True, False), (4, False, False, True), (1, False, True, True),
])
def test_rtmosr_matches_jax(scale, unshuffle, dccm, se):
    tm, jm = both(_sd(scale, unshuffle, dccm, se, seed=scale), _x(11, 13), 'RTMoSR', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'RTMoSR')
    assert (tm.config.dccm, tm.config.se, tm.config.unshuffle_mod, tm.config.n_blocks) == (dccm, se, unshuffle, 2)
    assert set(tm.params) == set(jm.params)
    assert not any(k.endswith(('.alpha', '.alpha1', '.conv1.k0', '.conv3.sk.weight')) for k in tm.params)


def test_rtmosr_2x_unshuffle_routes_its_8_convs(monkeypatch):
    """The bench configuration (dim 64, ffn 2, two blocks, 2x with the
    unshuffle stem): the 12 -> 64 stem, per block fc1 64 -> 256, the pooled
    branch's 64 -> 256 and fc2 128 -> 64 (Mish), the 64 -> 48 head; the
    OmniShift and the CSE stay plain."""
    tm = resselt_tpu_torch.load_from_state_dict(make_rtmosr(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 16, 20, 3)
    assert calls.calls == [(12, 64, 'linear')] + [(64, 256, 'linear'), (64, 256, 'linear'),
                                                  (128, 64, 'mish')] * 2 + [(64, 48, 'linear')]


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(seed=5), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=6), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(2, True, seed=8), extra) == (60, 76, 3)
