"""The port's new functional ops and upsamplers (resselt_tpu_torch.nn)
against the JAX package's functions on the same numpy inputs, on the CPU in
f32: ``conv_transpose2d``, ``interpolate_bilinear`` (corners aligned and
not, ``size=`` and ``scale_factor=``), ``max_pool2d``, ``pad_to_multiple``'s
modes; ``conv_pixel_shuffle``; every ``uni_upsample`` mode and every
``uni_upsample_v3`` mode at each scale it takes, with the mid width equal
to the input's and not (the dysample and lda branches differ), and
``lda_aqu`` alone with and without its relative-position table.  The ops
are held to 1e-5, the upsamplers to 1e-4 (a chain of convs in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resselt_tpu.nn import functional as JF
from resselt_tpu.nn import upsample as JU
from resselt_tpu.nn.params import PTree as JPTree
from resselt_tpu_torch.nn import functional as F
from resselt_tpu_torch.nn import upsample as U
from resselt_tpu_torch.nn.params import PTree
from resselt_tpu_torch.zoo import _lda_aqu, _Maker, _uni_upsample_v3


torch.set_num_threads(2)

OP_TOL = 1e-5
UP_TOL = 1e-4


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err < tol, f'max err {err}'


def strong(sd, seed, gain=0.7):
    """The layout of ``sd`` with weights of order ``gain`` / sqrt(fan in),
    norm scales and temperatures near one, bias tables (FDAT's window
    ``bias``, OmniSR's ``rel_pos_bias``, LDA_AQU's table) of order one and
    biases of order 0.1, so that every branch moves the output; integer
    buffers and DySample's initial positions kept."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        if v.dtype.kind != 'f' or k.endswith('init_pos'):
            out[k] = v
        elif k.endswith(('relative_position_bias_table', 'attn.bias', 'rel_pos_bias.weight')):
            out[k] = rng.standard_normal(v.shape).astype(np.float32)
        elif k.endswith(('temp', 'temperature')) or (v.ndim == 1 and k.endswith('weight')):
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif v.ndim >= 2:
            out[k] = (rng.standard_normal(v.shape) * gain / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
        else:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def _trees(sd):
    return JPTree({k: jnp.asarray(v) for k, v in sd.items()}), PTree({k: torch.from_numpy(v) for k, v in sd.items()})


# -- functional ops -------------------------------------------------------------------


@pytest.mark.parametrize('cin,cout,k,stride,padding,output_padding,groups', [
    (8, 6, 4, 2, 1, 0, 1), (8, 6, 3, 3, 0, 0, 1), (6, 4, 4, 2, 1, 1, 1), (8, 8, 3, 2, 1, 1, 2),
    (4, 6, 5, 1, 2, 0, 1), (6, 9, 3, (2, 3), (1, 0), 0, 3),
])
def test_conv_transpose2d(cin, cout, k, stride, padding, output_padding, groups):
    x = _rand((2, 7, 9, cin))
    w = _rand((cin, cout // groups, k, k), 1) * 0.2
    b = _rand((cout,), 2)
    want = JF.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, padding, output_padding, groups)
    got = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride, padding,
                             output_padding, groups)
    assert got.is_contiguous()
    _close(got, want, OP_TOL)


@pytest.mark.parametrize('align_corners', [False, True])
@pytest.mark.parametrize('hw,kwargs', [
    ((5, 7), {'size': (12, 17)}), ((12, 17), {'size': (5, 7)}), ((9, 6), {'size': (9, 13)}),
    ((5, 7), {'scale_factor': 2}), ((6, 4), {'scale_factor': 3}), ((7, 5), {'scale_factor': (2, 1.5)}),
    ((16, 16), {'scale_factor': 0.5}),
])
def test_interpolate_bilinear(align_corners, hw, kwargs):
    x = _rand((2, *hw, 3))
    want = JF.interpolate_bilinear(jnp.asarray(x), align_corners=align_corners, **kwargs)
    got = F.interpolate_bilinear(torch.from_numpy(x), align_corners=align_corners, **kwargs)
    _close(got, want, OP_TOL)


@pytest.mark.parametrize('hw,kernel,stride,padding', [
    ((11, 11), 7, 3, 0), ((20, 17), 7, 3, 0), ((9, 8), 3, 2, 1), ((8, 8), 2, None, 0), ((10, 7), (3, 2), (2, 1), 0),
])
def test_max_pool2d(hw, kernel, stride, padding):
    x = _rand((2, *hw, 5))
    want = JF.max_pool2d(jnp.asarray(x), kernel, stride, padding)
    got = F.max_pool2d(torch.from_numpy(x), kernel, stride, padding)
    _close(got, want, OP_TOL)


@pytest.mark.parametrize('mode,value', [('reflect', 0.0), ('constant', 0.0), ('constant', 0.25), ('replicate', 0.0),
                                        ('circular', 0.0)])
@pytest.mark.parametrize('hw,multiple', [((13, 10), 8), ((16, 16), 8), ((5, 7), 4)])
def test_pad_to_multiple_modes(mode, value, hw, multiple):
    x = _rand((1, *hw, 3))
    want = JF.pad_to_multiple(jnp.asarray(x), multiple, mode=mode, value=value)
    got = F.pad_to_multiple(torch.from_numpy(x), multiple, mode=mode, value=value)
    _close(got, want, OP_TOL)


def test_pad_to_multiple_reflects_by_default():
    x = torch.from_numpy(_rand((1, 5, 3, 2)))
    assert torch.equal(F.pad_to_multiple(x, 8), F.pad_to_multiple(x, 8, mode='reflect'))


# -- upsamplers -----------------------------------------------------------------------


def test_conv_pixel_shuffle():
    m = _Maker(1)
    m.conv('tail', 3 * 9, 8, 3)
    sd = strong(m.sd, 1)
    jp, tp = _trees(sd)
    x = _rand((2, 6, 5, 8))
    want = JU.conv_pixel_shuffle(jp, jnp.asarray(x), 'tail', 3)
    got = U.conv_pixel_shuffle(tp, torch.from_numpy(x), 'tail', 3)
    _close(got, want, UP_TOL)


def _upsampler(mode, scale, c, mid, out=3, seed=0):
    m = _Maker(seed)
    _uni_upsample_v3(m, 'up', mode, scale, c, out, mid)
    sd = strong(m.sd, seed)
    return {k[3:]: v for k, v in sd.items()}  # 'up.' dropped


_V1 = [(mode, scale, mid) for mode, scales in (('conv', (2,)), ('pixelshuffledirect', (2, 3, 4)),
                                               ('pixelshuffle', (2, 3, 4)), ('nearest+conv', (2, 3, 4)),
                                               ('dysample', (2, 3, 4)))
       for scale in scales for mid in (16, 12)]


@pytest.mark.parametrize('mode,scale,mid', _V1)
def test_uni_upsample_modes(mode, scale, mid):
    sd = _upsampler(mode, scale, 16, mid, seed=scale)
    jp, tp = _trees(sd)
    x = _rand((2, 7, 6, 16), 3)
    want = JU.uni_upsample(jp, jnp.asarray(x), mode, scale, 3, mid)
    got = U.uni_upsample(tp, torch.from_numpy(x), mode, scale, 3, mid)
    assert got.shape[1:3] == ((7, 6) if mode == 'conv' else (7 * scale, 6 * scale))
    _close(got, want, UP_TOL)


_V3 = [(mode, scale, mid) for mode, scales in (('conv', (1,)), ('pixelshuffledirect', (2, 4)), ('pixelshuffle', (2, 3)),
                                               ('nearest+conv', (2, 4)), ('dysample', (1, 2, 3)),
                                               ('transpose+conv', (2, 3, 4)), ('lda', (1, 2, 3)),
                                               ('pa_up', (2, 3, 4)))
       for scale in scales for mid in (16, 24)]


@pytest.mark.parametrize('mode,scale,mid', _V3)
def test_uni_upsample_v3_modes(mode, scale, mid):
    sd = _upsampler(mode, scale, 16, mid, seed=scale + 10)
    if scale == 1:
        assert sorted(sd) == ['0.bias', '0.weight']  # one conv, whatever the mode
    jp, tp = _trees(sd)
    x = _rand((2, 7, 6, 16), 4)
    want = JU.uni_upsample_v3(jp, jnp.asarray(x), mode, scale, 3, mid, group=4, dysample_end_kernel=1)
    got = U.uni_upsample_v3(tp, torch.from_numpy(x), mode, scale, 3, mid, group=4, dysample_end_kernel=1)
    assert got.shape == (2, 7 * scale, 6 * scale, 3)
    _close(got, want, UP_TOL)


@pytest.mark.parametrize('rpb,heads', [(True, 1), (True, 2), (False, 1)])
@pytest.mark.parametrize('scale', [2, 3])
def test_lda_aqu(rpb, heads, scale):
    m = _Maker(5)
    _lda_aqu(m, 'lda', 16, heads=heads)
    sd = strong({k[4:]: v for k, v in m.sd.items()}, 5)
    if not rpb:
        del sd['relative_position_bias_table']
    jp, tp = _trees(sd)
    x = _rand((2, 6, 5, 16), 6)
    want = JU.lda_aqu(jp, jnp.asarray(x), scale)
    got = U.lda_aqu(tp, torch.from_numpy(x), scale)
    assert got.shape == (2, 6 * scale, 5 * scale, 16)
    _close(got, want, UP_TOL)


def test_lda_aqu_base_offset_is_the_reference_grid():
    off = U._lda_base_offset(3).reshape(9, 2)
    assert off[0].tolist() == [-1.0, -1.0] and off[1].tolist() == [-1.0, 0.0] and off[4].tolist() == [0.0, 0.0]
    assert off[8].tolist() == [1.0, 1.0]


def test_unknown_modes_raise():
    tp = PTree({})
    x = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError):
        U.uni_upsample(tp, x, 'bicubic', 2, 3, 8)
    with pytest.raises(ValueError):
        U.uni_upsample_v3(tp, x, 'bicubic', 2, 3, 8)
