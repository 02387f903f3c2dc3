"""The port's FIGSR against resselt_tpu on the same state dicts
(``zoo.make_figsr``), on the CPU in f32, with test_figsr.py's TOL (1e-3):
test_figsr.py's variants (pixelshuffledirect 4x, pixelshuffle 2x) at its
widths (dim 16, expansion 2, two blocks, gc 4, square kernel 5, band 7) on
its 15x18 input (the halo's evenness pad and crop run), a 3x3 ``convhw``
on the 3x3 kernel and a DySample tail; weights of order one with the
serialized ``eps`` / ``rms`` buffers and a global affine near identity;
the routed convs of the bench configuration; params carried across from a
JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_figsr
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _sd(scale=4, upsampler='pixelshuffledirect', square=5, band=7, seed=0):
    """test_figsr.py's model, weights of order one; the norms' ``eps`` /
    ``rms`` buffers and the global ``shift`` / ``scale_norm`` as built
    (test_figsr.py restores the buffers after randomizing)."""
    sd = make_figsr(16, 2, scale, upsampler=upsampler, mid_dim=16, gc=4, square_kernel_size=square,
                    band_kernel_size=band, seed=seed)
    keep = ('.eps', '.rms', 'shift', 'scale_norm')
    return {k: sd[k] if k.endswith(keep) else v for k, v in strong(sd, seed).items()}


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('scale,upsampler,square', [
    (4, 'pixelshuffledirect', 5), (2, 'pixelshuffle', 5), (2, 'pixelshuffledirect', 3), (3, 'dysample', 3),
])
def test_figsr_matches_jax(scale, upsampler, square):
    tm, _ = both(_sd(scale, upsampler, square, seed=scale), _x(15, 18), 'FIGSR', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'FIGSR')
    assert (tm.config.gc, tm.config.square_kernel_size, tm.config.band_kernel_size) == (4, square, 7)


def test_figsr_4x_routes_its_57_convs(monkeypatch):
    """The bench configuration (dim 64, 18 blocks, expansion 2, gc 8, a
    3x3 ``convhw``, 4x pixelshuffledirect): the stem, per block fc1 64 ->
    256, ``convhw`` 8 -> 8 and fc2 128 -> 64, the second half's 64 -> 64,
    the head; the bands, the 1x1 convs and the FourierUnit stay plain."""
    tm = resselt_tpu_torch.load_from_state_dict(make_figsr(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    assert calls.calls == ([(3, 64, 'linear')] + [(64, 256, 'linear'), (8, 8, 'linear'), (128, 64, 'linear')] * 18
                           + [(64, 64, 'linear'), (64, 48, 'linear')])


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(seed=6), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(2, seed=7), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(2, 'pixelshuffle', seed=8), extra) == (60, 76, 3)
