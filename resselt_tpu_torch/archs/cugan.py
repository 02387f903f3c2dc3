"""CUGAN (Real-CUGAN): cascaded UNets with fixed halo padding.

Counterpart of ``resselt_tpu/archs/cugan.py``: the same config inference,
metadata and forward.  UNet1 / UNet1x3 / UNet2 with valid (pad-0) convs
followed by lrelu 0.1, stride-2 downsampling convs, transposed-conv
upsampling, interior negative-pad crops and SE blocks; the four variants
(2x, 3x, 4x, 2x_fast) with their reflect halo pads, any pad length; ``pro``
checkpoints remap the input range.  Every conv here is unpadded, strided or
transposed, so none is a same-padded 3x3: the whole forward is plain torch
(cuDNN), with no hand-written kernel and no ``prepare``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..nn import functional as F
from ..nn.params import PTree


@dataclass(frozen=True)
class CUGANConfig:
    variant: str  # '2x' | '3x' | '4x' | '2x_fast'
    in_channels: int
    out_channels: int
    pro: bool


def _se(p: PTree, x):
    x0 = x.mean(dim=(1, 2), keepdim=True)
    x0 = F.relu(F.conv2d(x0, p['conv1.weight'], p.get('conv1.bias')))
    x0 = F.sigmoid(F.conv2d(x0, p['conv2.weight'], p.get('conv2.bias')))
    return x * x0


def _unet_conv(p: PTree, x, se: bool):
    z = F.leaky_relu(p.conv('conv.0', x), 0.1)
    z = F.leaky_relu(p.conv('conv.2', z), 0.1)
    if se:
        z = _se(p.sub('seblock'), z)
    return z


def _deconv(p: PTree, name: str, x, stride, padding):
    return F.conv_transpose2d(x, p[f'{name}.weight'], p.get(f'{name}.bias'), stride=stride, padding=padding)


def _unet1(p: PTree, x, deconv_k: int):
    """UNet1 / UNet1x3 (cugan/arch.py:99-148, 151-200)."""
    x1 = _unet_conv(p.sub('conv1'), x, se=False)
    x2 = p.conv('conv1_down', x1, stride=2)
    x1 = F.pad2d(x1, (-4, -4, -4, -4))
    x2 = F.leaky_relu(x2, 0.1)
    x2 = _unet_conv(p.sub('conv2'), x2, se=True)
    x2 = _deconv(p, 'conv2_up', x2, 2, 0)
    x2 = F.leaky_relu(x2, 0.1)
    x3 = F.leaky_relu(p.conv('conv3', x1 + x2), 0.1)
    if deconv_k == 4:
        return _deconv(p, 'conv_bottom', x3, 2, 3)
    if deconv_k == 5:
        return _deconv(p, 'conv_bottom', x3, 3, 2)
    return p.conv('conv_bottom', x3)


def _unet2(p: PTree, x):
    """UNet2 (cugan/arch.py:203-252), conv (not deconv) bottom."""
    x1 = _unet_conv(p.sub('conv1'), x, se=False)
    x2 = p.conv('conv1_down', x1, stride=2)
    x1 = F.pad2d(x1, (-16, -16, -16, -16))
    x2 = F.leaky_relu(x2, 0.1)
    x2 = _unet_conv(p.sub('conv2'), x2, se=True)
    x3 = p.conv('conv2_down', x2, stride=2)
    x2 = F.pad2d(x2, (-4, -4, -4, -4))
    x3 = F.leaky_relu(x3, 0.1)
    x3 = _unet_conv(p.sub('conv3'), x3, se=True)
    x3 = _deconv(p, 'conv3_up', x3, 2, 0)
    x3 = F.leaky_relu(x3, 0.1)
    x4 = _unet_conv(p.sub('conv4'), x2 + x3, se=True)
    x4 = _deconv(p, 'conv4_up', x4, 2, 0)
    x4 = F.leaky_relu(x4, 0.1)
    x5 = F.leaky_relu(p.conv('conv5', x1 + x4), 0.1)
    return p.conv('conv_bottom', x5)


def _cascade(p: PTree, x, deconv_k: int):
    """UNet1, then UNet2 on its output plus that output's cropped centre."""
    x = _unet1(p.sub('unet1'), x, deconv_k)
    return _unet2(p.sub('unet2'), x) + F.pad2d(x, (-20, -20, -20, -20))


def apply(cfg: CUGANConfig, params, x):
    p = PTree(params)
    h0, w0 = x.shape[1], x.shape[2]
    if cfg.pro:
        x = x * 0.7 + 0.15

    mult = 4 if cfg.variant == '3x' else 2
    ph, pw = ((h0 - 1) // mult + 1) * mult, ((w0 - 1) // mult + 1) * mult
    halo = {'2x': 18, '3x': 14, '4x': 19, '2x_fast': 38}[cfg.variant]
    x00 = x
    x = F.pad2d(x, (halo, halo + pw - w0, halo, halo + ph - h0), 'reflect')
    if cfg.variant in ('2x', '3x'):
        s = 2 if cfg.variant == '2x' else 3
        out = _cascade(p, x, deconv_k=4 if s == 2 else 5)[:, : h0 * s, : w0 * s]
    else:
        s = 4 if cfg.variant == '4x' else 2
        if cfg.variant == '2x_fast':
            x = F.pixel_unshuffle(x, 2)
        x = p.conv('conv_final', _cascade(p, x, deconv_k=4))
        x = F.pixel_shuffle(F.pad2d(x, (-1, -1, -1, -1)), 2)
        out = x[:, : h0 * s, : w0 * s] + F.interpolate_nearest(x00, scale_factor=s)
    if cfg.pro:
        out = (out - 0.15) / 0.7
    return out


def _load(sd, device='cuda') -> SRModel:
    """Variant dispatch, as ``resselt_tpu/archs/cugan.py::_load``."""
    pro = 'pro' in sd
    in_channels = sd['unet1.conv1.conv.0.weight'].shape[1]

    if 'conv_final.weight' in sd and in_channels == 12:
        variant, scale = '2x_fast', 2
        in_channels = out_channels = 3
    elif 'conv_final.weight' in sd:
        variant, scale = '4x', 4
        out_channels = 3
    elif sd['unet1.conv_bottom.weight'].shape[2] == 5:
        variant, scale = '3x', 3
        out_channels = sd['unet2.conv_bottom.weight'].shape[0]
    else:
        variant, scale = '2x', 2
        out_channels = sd['unet2.conv_bottom.weight'].shape[0]

    cfg = CUGANConfig(variant=variant, in_channels=in_channels, out_channels=out_channels, pro=pro)
    params = {k: v for k, v in sd.items() if k != 'pro'}
    meta = ModelMetadata(in_channels=in_channels, out_channels=out_channels, upscale=scale, name='CUGAN')
    return SRModel('CuGAN', cfg, params_from_numpy(params, device), meta, apply)


ARCH = Architecture(
    id='CuGAN',
    detect_condition=KeyCondition.has_all(
        'unet1.conv1.conv.0.weight',
        'unet1.conv1.conv.2.weight',
        'unet1.conv1_down.weight',
        'unet1.conv2.conv.0.weight',
        'unet1.conv2.conv.2.weight',
        'unet1.conv2.seblock.conv1.weight',
        'unet1.conv2_up.weight',
        'unet1.conv_bottom.weight',
        'unet2.conv1.conv.0.weight',
        'unet2.conv1_down.weight',
        'unet2.conv2.conv.0.weight',
        'unet2.conv2.seblock.conv1.weight',
        'unet2.conv3.conv.0.weight',
        'unet2.conv3.seblock.conv1.weight',
        'unet2.conv3_up.weight',
        'unet2.conv4.conv.0.weight',
        'unet2.conv4_up.weight',
        'unet2.conv5.weight',
        'unet2.conv_bottom.weight',
    ),
    load_fn=_load,
)
