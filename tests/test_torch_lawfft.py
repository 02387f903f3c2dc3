"""The port's LAWFFT against resselt_tpu on the same state dicts
(``zoo.make_lawfft``), on the CPU in f32, with test_lawfft.py's TOL (1e-3):
test_lawfft.py's variants (pixelshuffledirect 2x, pixelshuffle 4x, the
unshuffle stem) at its widths (dim 16, split 0.25, one residual group of
two meta blocks, window 8) on inputs that are not aligned (the JAX package
recovers an unshuffle checkpoint's true scale), and a DySample 3x; weights
of order one; DynamicLocal against a per-sample loop; the routed convs of
the bench configuration; params carried across from a JAX model; tiled and
CLI output."""

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import resselt_tpu_torch
from resselt_tpu_torch.archs import lawfft
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.nn.params import PTree
from resselt_tpu_torch.zoo import make_lawfft
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _sd(scale=2, upsampler='pixelshuffledirect', unshuffle=False, seed=0):
    return strong(make_lawfft(16, 1, 2, scale, upsampler=upsampler, mid_dim=16, unshuffle_mod=unshuffle, seed=seed),
                  seed)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize('scale,upsampler,unshuffle', [
    (2, 'pixelshuffledirect', False), (4, 'pixelshuffle', False), (2, 'pixelshuffledirect', True),
    (3, 'dysample', False),
])
def test_lawfft_matches_jax(scale, upsampler, unshuffle):
    tm, _ = both(_sd(scale, upsampler, unshuffle, seed=scale), _x(13, 19), 'LAWFFT', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'LAWFFT')
    assert (tm.config.unshuffle_mod, tm.config.unshuffle, tm.config.window_size) == (unshuffle, 2 if unshuffle else 1,
                                                                                      8)


def test_dynamic_local_is_each_sample_with_its_own_kernels():
    """The grouped conv over the batch folded into the channels is, for
    each sample, a depthwise conv with the kernels generated from it."""
    sd = _sd(seed=4)
    p = PTree(lawfft.prepare(None, {k: torch.from_numpy(v) for k, v in sd.items()}, torch.float32))
    loc = p.sub('body.0.residual.2')
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 9, 11, 16)).astype(np.float32))
    got = lawfft.dynamic_local(loc, x, 3)
    for i in range(3):
        g = x[i : i + 1].mean(dim=(1, 2), keepdim=True)
        g = TF.relu(TF.conv2d(g.permute(0, 3, 1, 2), loc['kernel_gen.1'].w, loc['kernel_gen.1'].b))
        kern = TF.conv2d(g, loc['kernel_gen.3'].w, loc['kernel_gen.3'].b).reshape(16, 1, 3, 3)
        want = TF.conv2d(x[i : i + 1].permute(0, 3, 1, 2), kern, padding=1, groups=16).permute(0, 2, 3, 1)
        torch.testing.assert_close(got[i : i + 1], want, rtol=1e-5, atol=1e-5)


def test_lawfft_4x_routes_its_2_convs(monkeypatch):
    """The bench configuration (dim 64, four groups of six meta blocks, 4x
    pixelshuffledirect): only the stem and the head are 3x3 convs."""
    tm = resselt_tpu_torch.load_from_state_dict(make_lawfft(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    assert calls.calls == [(3, 64, 'linear'), (64, 48, 'linear')]


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(seed=6), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=7), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(2, unshuffle=True, seed=8), extra) == (60, 76, 3)
