"""The port's block factories (resselt_tpu_torch.nn.blocks) against
resselt_tpu.nn.blocks on the CPU: every case of tests/test_blocks.py
(conv_block in the three modes with the three activations, the two padding
layers, batch norm; concat / shortcut; resnet_block in its four
configurations; pixelshuffle and upconv), plus instance norm, each on the
same seeded weights carried across under the reference's param names, on
the raw params and on the convs ``ops.conv_route.prepare_convs`` builds
(the 3x3 convs routed to the conv3x3 kernel, whose plain version runs
here).  Tolerance 1e-5, batch norm 1e-4 (tests/test_blocks.py's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resselt_tpu.nn import blocks as JB
from resselt_tpu.nn.params import PTree as JPTree

from resselt_tpu_torch.nn import blocks as TB
from resselt_tpu_torch.nn.params import PTree
from resselt_tpu_torch.ops.conv_route import prepare_convs

TOL = 1e-5
BN_TOL = 1e-4


def _x(c=8, h=12, w=14, seed=0):
    return np.random.default_rng(seed).standard_normal((2, h, w, c)).astype(np.float32)


def _conv(rng, name, cout, cin, k=3):
    return {f'{name}.weight': (rng.standard_normal((cout, cin, k, k)) * 0.1).astype(np.float32),
            f'{name}.bias': (rng.standard_normal(cout) * 0.1).astype(np.float32)}


def _bn(rng, name, c):
    return {f'{name}.weight': (1 + rng.standard_normal(c) * 0.1).astype(np.float32),
            f'{name}.bias': (rng.standard_normal(c) * 0.1).astype(np.float32),
            f'{name}.running_mean': (rng.standard_normal(c) * 0.1).astype(np.float32),
            f'{name}.running_var': (0.5 + rng.random(c)).astype(np.float32)}


def _check(name, params, x, tol=TOL, routed=(), **kw):
    """``blocks.{name}`` in both packages on the same params: the port on
    the raw params and on ``prepare_convs``' (``routed``: the convs that
    must be prepared for the kernel), each within ``tol`` of JAX."""
    want = np.asarray(getattr(JB, name)(JPTree({k: jnp.asarray(v) for k, v in params.items()}), jnp.asarray(x), **kw))
    raw = {k: torch.from_numpy(v) for k, v in params.items()}
    prepared = prepare_convs(raw, torch.float32)
    assert {k for k, v in prepared.items() if getattr(v, 'kernel', False)} == set(routed)
    for p in (raw, prepared):
        got = getattr(TB, name)(PTree(p), torch.from_numpy(x), **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize('mode', ['CNA', 'NAC', 'CNAC'])
@pytest.mark.parametrize('act_type', ['relu', 'leakyrelu', 'prelu'])
def test_conv_block_modes(mode, act_type):
    rng = np.random.default_rng(1)
    params = _conv(rng, 'conv', 16, 8)
    if act_type == 'prelu':
        params['act.weight'] = np.array([0.2 + rng.standard_normal() * 0.1], np.float32)
    _check('conv_block', params, _x(), routed={'conv'}, conv_name='conv', act_type=act_type, mode=mode)


@pytest.mark.parametrize('pad_type', ['reflect', 'replicate'])
def test_conv_block_pad_types(pad_type):
    """The prepared 3x3 runs on the padded input; its added ring is cropped."""
    params = _conv(np.random.default_rng(2), 'conv', 8, 8)
    _check('conv_block', params, _x(), routed={'conv'}, conv_name='conv', pad_type=pad_type, act_type='relu')


def test_conv_block_batch_norm():
    rng = np.random.default_rng(3)
    params = {**_conv(rng, 'conv', 16, 8), **_bn(rng, 'norm', 16)}
    _check('conv_block', params, _x(), tol=BN_TOL, routed={'conv'}, conv_name='conv', norm_type='batch',
           act_type='relu', mode='CNA')


@pytest.mark.parametrize('mode', ['CNA', 'NAC'])
def test_conv_block_instance_norm(mode):
    params = _conv(np.random.default_rng(4), 'conv', 8, 8)
    _check('conv_block', params, _x(), routed={'conv'}, conv_name='conv', norm_type='instance',
           act_type='leakyrelu', mode=mode)


def test_conv_block_1x1_and_5x5_reflect():
    """Convs the kernel does not take: a 1x1 (no padding) and a 5x5 after
    reflect padding (the prepared ``F.conv2d`` conv, same-padded, cropped)."""
    rng = np.random.default_rng(5)
    _check('conv_block', _conv(rng, 'conv', 8, 8, k=1), _x(), conv_name='conv', pad_type='reflect')
    _check('conv_block', _conv(rng, 'conv', 8, 8, k=5), _x(), conv_name='conv', pad_type='reflect')


def test_concat_shortcut_blocks():
    x = torch.from_numpy(_x())
    assert torch.equal(TB.concat_block(lambda t: t * 2.0, x), torch.cat([x, x * 2], dim=-1))
    assert torch.equal(TB.shortcut_block(lambda t: t * 2.0, x), x * 3)
    want = np.asarray(JB.concat_block(lambda t: t * 2.0, jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(TB.concat_block(lambda t: t * 2.0, x).numpy(), want)
    want = np.asarray(JB.shortcut_block(lambda t: t * 2.0, jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(TB.shortcut_block(lambda t: t * 2.0, x).numpy(), want)


# the reference's sequential() indices of the two convs of ResNetBlock(8, 8, 8, mode=...)
_RES_CONVS = {'CNA': (0, 2), 'NAC': (1, 3), 'CNAC': (0, 2)}


@pytest.mark.parametrize('mode,res_scale', [('CNA', 1.0), ('CNA', 0.1), ('NAC', 1.0), ('CNAC', 1.0)])
def test_resnet_block(mode, res_scale):
    rng = np.random.default_rng(6)
    a, b = _RES_CONVS[mode]
    params = {**_conv(rng, f'res.{a}', 8, 8), **_conv(rng, f'res.{b}', 8, 8)}
    _check('resnet_block', params, _x(), routed={f'res.{a}', f'res.{b}'}, mode=mode, res_scale=res_scale)


def test_resnet_block_batch_norm():
    rng = np.random.default_rng(7)
    params = {**_conv(rng, 'res.0', 8, 8), **_bn(rng, 'res.1', 8), **_conv(rng, 'res.3', 8, 8),
              **_bn(rng, 'res.4', 8)}
    _check('resnet_block', params, _x(), tol=BN_TOL, routed={'res.0', 'res.3'}, norm_type='batch', mode='CNA')


def test_pixelshuffle_and_upconv_blocks():
    rng = np.random.default_rng(8)
    _check('pixelshuffle_block', _conv(rng, '0', 16, 8), _x(), routed={'0'}, upscale_factor=2, conv_name='0',
           act_type='relu')
    _check('upconv_block', _conv(rng, '1', 4, 8), _x(), routed={'1'}, upscale_factor=2, conv_name='1',
           act_type='relu')


def test_get_valid_padding_and_errors():
    for k, d in ((1, 1), (3, 1), (3, 2), (5, 3), (7, 1)):
        assert TB.get_valid_padding(k, d) == JB.get_valid_padding(k, d)
    x = torch.from_numpy(_x())
    p = PTree({k: torch.from_numpy(v) for k, v in _conv(np.random.default_rng(9), 'conv', 8, 8).items()})
    with pytest.raises(NotImplementedError):
        TB.conv_block(p, x, 'conv', act_type='gelu')
    with pytest.raises(NotImplementedError):
        TB.conv_block(p, x, 'conv', norm_type='layer')
    with pytest.raises(NotImplementedError):
        TB.conv_block(p, x, 'conv', pad_type='circular')
    with pytest.raises(NotImplementedError):
        TB.upconv_block(p, x, conv_name='conv', mode='bilinear')


def test_conv_block_keeps_int8_discovery():
    """The weight's shape is read without consuming it, so quantization
    discovery marks a conv_block's conv int8-safe."""
    from resselt_tpu_torch.nn import params as params_mod

    raw = {k: torch.from_numpy(v) for k, v in _conv(np.random.default_rng(10), 'conv', 32, 32).items()}
    rec = {'safe': set(), 'raw': set()}
    params_mod._INT8_DISCOVERY = rec
    try:
        TB.conv_block(PTree(params_mod.RecordingParams(raw)), torch.zeros(1, 8, 8, 32), 'conv')
    finally:
        params_mod._INT8_DISCOVERY = None
    assert 'conv.weight' in rec['safe'] and 'conv.weight' not in rec['raw']
