"""Functional equivalents of the reference's public block-factory surface
(resselt/utilities/block.py) for user code building ESRGAN-lineage models.

Counterpart of ``resselt_tpu/nn/blocks.py``: each factory is an
``apply``-style function of a ``PTree`` scope with the reference's
mode / act / norm / pad options, and the same param names.  Covered:

* ``conv_block`` CNA / NAC / CNAC modes with zero / reflect / replicate
  padding, relu / leakyrelu / prelu activations, batch / instance norm
  (block.py:148-200 and the act / norm / pad factories :17-63)
* ``concat_block`` / ``shortcut_block`` (:66-98)
* ``resnet_block`` 3-3 EDSR-style with res_scale (:206-274)
* ``pixelshuffle_block`` (:477-507) and ``upconv_block`` (:510-537)

Every conv goes through ``PTree.conv``.  On the raw params that is
``F.conv2d``; on params that ``ops.conv_route.prepare_convs`` built for a
compute dtype, a same-padded 3x3 conv with groups 1 runs the 3x3 kernel
(``csrc/conv3x3.cu`` on the card) by that module's one rule, and a 3x3 after
reflect or replicate padding too: the kernel runs on the padded input and
the ring it adds is cropped.
"""

from __future__ import annotations

import torch

from . import functional as F
from .params import PTree


def get_valid_padding(kernel_size: int, dilation: int = 1) -> int:
    """block.py:131-134."""
    kernel_size = kernel_size + (kernel_size - 1) * (dilation - 1)
    return (kernel_size - 1) // 2


def _act(x, act_type: str | None, neg_slope: float = 0.2, prelu_weight=None):
    if act_type is None:
        return x
    act_type = act_type.lower()
    if act_type == 'relu':
        return F.relu(x)
    if act_type == 'leakyrelu':
        return F.leaky_relu(x, neg_slope)
    if act_type == 'prelu':
        return torch.where(x >= 0, x, x * (neg_slope if prelu_weight is None else prelu_weight.to(x.dtype)))
    raise NotImplementedError(f'activation layer [{act_type}] is not found')


def _norm(p: PTree, name: str, x, norm_type: str | None, eps: float = 1e-5):
    if norm_type is None:
        return x
    norm_type = norm_type.lower()
    if norm_type == 'batch':
        return p.batch_norm(name, x, eps=eps)
    if norm_type == 'instance':
        # nn.InstanceNorm2d(affine=False): per-sample, per-channel spatial norm
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        return (x - mean) / torch.sqrt(var + eps)
    raise NotImplementedError(f'normalization layer [{norm_type}] is not found')


def _pad(x, pad_type: str, padding: int):
    if padding == 0 or pad_type == 'zero':
        return x
    mode = {'reflect': 'reflect', 'replicate': 'replicate'}.get(pad_type.lower())
    if mode is None:
        raise NotImplementedError(f'padding layer [{pad_type}] is not implemented')
    return F.pad2d(x, (padding,) * 4, mode=mode)


def conv_block(p: PTree, x, conv_name: str = 'conv', *, kernel_size: int | None = None,
               stride: int = 1, dilation: int = 1, groups: int = 1, pad_type: str = 'zero',
               norm_type: str | None = None, act_type: str | None = 'relu',
               mode: str = 'CNA', norm_name: str = 'norm', neg_slope: float = 0.2):
    """conv_block CNA / NAC / CNAC (block.py:148-200).

    ``p[conv_name + '.weight']`` supplies the conv weight (OIHW), or ``p``
    holds the conv ``prepare_convs`` built under ``conv_name``; padding is
    the reference's 'valid' padding derived from the kernel.  NAC applies
    norm (over in_nc) and activation before the conv; CNAC is conv->norm->
    act with the activation suppressed by ``resnet_block``'s second conv,
    exactly as the reference composes it."""
    assert mode in ('CNA', 'NAC', 'CNAC'), f'Wrong conv mode [{mode}]'
    # shape-only read: a full p[...] read would taint the weight for int8
    # discovery (nn/params._INT8_DISCOVERY) and silently block quantization
    k = int(kernel_size if kernel_size is not None else p.shape(f'{conv_name}.weight')[-1])
    padding = get_valid_padding(k, dilation)

    def conv(v):
        v = _pad(v, pad_type, padding)
        if pad_type == 'zero' or padding == 0 or conv_name not in p:
            return p.conv(conv_name, v, stride=stride, padding=padding if pad_type == 'zero' else 0,
                          dilation=dilation, groups=groups)
        # a prepared conv is same-padded: on the padded input its interior is the unpadded conv
        return p.conv(conv_name, v, stride=stride, padding=padding, dilation=dilation,
                      groups=groups)[:, padding:-padding, padding:-padding]

    if mode in ('CNA', 'CNAC'):
        x = conv(x)
        x = _norm(p, norm_name, x, norm_type)
        return _act(x, act_type, neg_slope, p.get('act.weight'))
    # NAC: norm -> act -> conv
    x = _norm(p, norm_name, x, norm_type)
    x = _act(x, act_type, neg_slope, p.get('act.weight'))
    return conv(x)


def concat_block(fn, x):
    """ConcatBlock (block.py:66-80): channel-concat a submodule's output."""
    return torch.cat([x, fn(x)], dim=-1)


def shortcut_block(fn, x):
    """ShortcutBlock (block.py:83-98): elementwise-sum a submodule's output."""
    return x + fn(x)


def resnet_block(p: PTree, x, *, kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 groups: int = 1, pad_type: str = 'zero', norm_type: str | None = None,
                 act_type: str | None = 'relu', mode: str = 'CNA', res_scale: float = 1.0):
    """ResNetBlock 3-3 EDSR style (block.py:206-274): two conv_blocks on the
    residual path (second one with act suppressed for CNA, act+norm for
    CNAC), scaled by ``res_scale``.  Params: ``res.0`` / ``res.1`` conv
    scopes mirroring the reference's ``sequential`` naming."""
    # the reference's sequential() flattener assigns indices to every module
    # (incl. parameter-free ReLU/pad layers), so locate the two convs by
    # their 4-D weights instead of assuming fixed indices (``res.{i}.weight``,
    # or ``res.{i}`` itself where ``prepare_convs`` built the conv)
    names = {'.'.join(k.split('.')[:2]) for k in p.keys()
             if k.startswith('res.') and (k.count('.') == 1 or k.endswith('.weight'))}
    convs = sorted(int(n.split('.')[1]) for n in names if len(p.shape(f'{n}.weight')) == 4)
    norms = sorted(
        (int(k.split('.')[1]) for k in p.keys()
         if k.startswith('res.') and k.endswith('.running_mean')),
    )
    kw = dict(kernel_size=kernel_size, stride=stride, dilation=dilation, groups=groups,
              pad_type=pad_type, norm_type=norm_type, mode=mode)
    res = conv_block(p, x, f'res.{convs[0]}', act_type=act_type,
                     norm_name=f'res.{norms[0]}' if norms else 'norm', **kw)
    act2, norm2 = act_type, norm_type
    if mode == 'CNA':
        act2 = None
    if mode == 'CNAC':
        act2 = None
        norm2 = None
    kw['norm_type'] = norm2
    res = conv_block(p, res, f'res.{convs[1]}', act_type=act2,
                     norm_name=f'res.{norms[1]}' if len(norms) > 1 else 'norm', **kw)
    return x + res * res_scale


def pixelshuffle_block(p: PTree, x, upscale_factor: int = 2, *, conv_name: str = '0',
                       pad_type: str = 'zero', norm_type: str | None = None,
                       act_type: str | None = 'relu'):
    """pixelshuffle_block (block.py:477-507): conv to out*r^2 channels,
    PixelShuffle, optional norm+act."""
    x = conv_block(p, x, conv_name, pad_type=pad_type, norm_type=None, act_type=None)
    x = F.pixel_shuffle(x, upscale_factor)
    x = _norm(p, 'norm', x, norm_type)
    return _act(x, act_type)


def upconv_block(p: PTree, x, upscale_factor: int = 2, *, conv_name: str = '1',
                 pad_type: str = 'zero', norm_type: str | None = None,
                 act_type: str | None = 'relu', mode: str = 'nearest'):
    """upconv_block (block.py:510-537): nearest upsample then conv_block."""
    if mode != 'nearest':
        raise NotImplementedError(f'upconv_block mode [{mode}]')
    x = F.interpolate_nearest(x, scale_factor=upscale_factor)
    return conv_block(p, x, conv_name, pad_type=pad_type, norm_type=norm_type,
                      act_type=act_type)
