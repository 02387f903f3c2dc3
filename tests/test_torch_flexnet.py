"""The port's FlexNet against resselt_tpu on the same state dicts
(``zoo.make_flexnet``), on the CPU in f32, with test_flexnet.py's TOL
(1e-3): test_flexnet.py's variants (the linear pipeline with the ps, n+c
(with the channel norm) and dys tails, the meta U-Net on a 40x70 input) at
its widths (dim 16, window 8, hidden rate 2) on its inputs, with weights of
order one; the window attentions through ``ops.window_mha`` (one head, the
zero bias) where the kernel takes the width and the plain path past it;
the routed convs of the bench configuration; params carried across from a
JAX model; tiled and CLI output."""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
import resselt_tpu_torch.nn.window as nw
from resselt_tpu_torch.core import ModelMetadata
from resselt_tpu_torch.zoo import make_flexnet
from tests.test_torch_conv_route import RoutedCalls, carried_params_match, cli_both, tiled_both
from tests.test_torch_dat import both
from tests.test_torch_upsample import strong


torch.set_num_threads(2)

TOL = 1e-3


def _sd(pipeline='linear', upsampler='ps', scale=2, channel_norm=False, seed=0):
    nb = (1, 1, 1, 1) if pipeline == 'meta' else (3, 2)
    return strong(make_flexnet(16, nb, scale, window_size=8, hidden_rate=2, channel_norm=channel_norm,
                               pipeline_type=pipeline, upsampler=upsampler, seed=seed), seed)


def _x(h, w, seed=3):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


class Attentions:
    """Records each window attention FlexNet hands to ``window_mha`` (the
    kernel's wrapper) as (windows, n, c, heads), and any that takes the
    plain path."""

    def __init__(self, monkeypatch):
        self.kernel, self.plain = [], []
        wrapped, plain = nw.window_mha, nw._mha_plain

        def kernel(q, k, v, bias, mask=None, *, num_heads, scale):
            assert mask is None and not bool(bias.any()) and tuple(bias.shape) == (1, q.shape[1], q.shape[1])
            assert scale == q.shape[-1] ** -0.5
            self.kernel.append((*q.shape, num_heads))
            return wrapped(q, k, v, bias, mask, num_heads=num_heads, scale=scale)

        def record_plain(q, *args):
            self.plain.append(tuple(q.shape))
            return plain(q, *args)

        monkeypatch.setattr(nw, 'window_mha', kernel)
        monkeypatch.setattr(nw, '_mha_plain', record_plain)


@pytest.mark.parametrize('pipeline,upsampler,scale,channel_norm', [
    ('linear', 'ps', 2, False), ('linear', 'n+c', 4, True), ('linear', 'dys', 2, False), ('meta', 'ps', 2, False),
    ('linear', 'n+c', 3, False),
])
def test_flexnet_matches_jax(pipeline, upsampler, scale, channel_norm):
    x = _x(40, 70) if pipeline == 'meta' else _x(11, 14)
    tm, _ = both(_sd(pipeline, upsampler, scale, channel_norm, seed=scale), x, 'FlexNet', TOL)
    assert tm.metadata == ModelMetadata(3, 3, scale, 'FlexNet')
    assert (tm.config.pipeline_type, tm.config.upsampler, tm.config.channel_norm) == (pipeline, upsampler, channel_norm)
    assert not any(k in tm.params for k in ('window_size', 'scale_factor'))


def test_linear_attentions_take_the_kernel(monkeypatch):
    """Every LMLTVIT of a linear model at dim 16: one head of 16 over 64
    tokens, the windows of the 16 x 16 padded image."""
    tm = resselt_tpu_torch.load_from_state_dict(_sd(seed=4), device='cpu')
    att = Attentions(monkeypatch)
    tm(_x(11, 14))
    assert att.kernel == [(4, 64, 16, 1)] * 5 and att.plain == []


def test_meta_attentions_past_head_dim_64_take_the_plain_path(monkeypatch):
    """The meta U-Net at dim 16 runs its levels at 16, 32, 64 and 128
    channels: the kernel's wrapper takes every one of them, enc3's 128 too
    (it took the plain path while the kernel stopped at head_dim 64); none
    takes the plain path."""
    tm = resselt_tpu_torch.load_from_state_dict(_sd('meta', seed=5), device='cpu')
    att = Attentions(monkeypatch)
    tm(_x(40, 70))
    assert [t[2] for t in att.kernel] == [16, 32, 64, 128, 64, 32, 16]
    assert att.kernel[3] == (2, 64, 128, 1)  # the 64 x 128 padded input at 1/8: two windows
    assert att.plain == []


def test_flexnet_4x_routes_its_16_convs(monkeypatch):
    """The bench configuration (dim 64, six groups of six blocks, 4x ps):
    the short cut's 3 -> 64 and 64 -> 64 (Mish), the stem, per group the
    ConvBlock's 128 -> 64 and 64 -> 64 (Mish), the 128 -> 48 head; the
    OmniShifts, LePE and 1x1 convs stay plain."""
    tm = resselt_tpu_torch.load_from_state_dict(make_flexnet(), device='cpu')
    calls = RoutedCalls(monkeypatch)
    assert tm(_x(8, 10)).shape == (1, 32, 40, 3)
    assert calls.calls == ([(3, 64, 'mish'), (64, 64, 'mish'), (3, 64, 'linear')]
                           + [(128, 64, 'mish'), (64, 64, 'mish')] * 6 + [(128, 48, 'linear')])


def test_params_from_numpy_carries_jax_params():
    carried_params_match(_sd(upsampler='dys', seed=6), _x(9, 12), TOL)


def test_tiled_matches_jax():
    img = np.random.default_rng(5).random((40, 46, 3), dtype=np.float32)
    assert tiled_both(_sd(seed=7), img, tile=16, tol=TOL).shape == (80, 92, 3)


@pytest.mark.parametrize('extra', [[], ['--tile', '16']], ids=['whole', 'tiled'])
def test_cli_matches_jax(tmp_path, extra):
    assert cli_both(tmp_path, _sd(upsampler='n+c', seed=8), extra) == (60, 76, 3)
