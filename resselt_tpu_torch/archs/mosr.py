"""MoSR: Mamba-Out Super-Resolution.

Counterpart of ``resselt_tpu/archs/mosr.py``: the same config inference,
metadata and forward, with the GPS (8-way geo-ensemble pixel shuffle)
upsampler (mosr/arch.py:8-32) and the ``(shortcut - 0.5)`` residual quirk
(arch.py:105,155).  Each 3x3 conv runs through ``ops.fused_conv3x3_act``
(``csrc/conv3x3.cu``; 54 launches per forward of ``mosr 4x``, 24 blocks,
dim 64, ``ps``): ``fc1`` with act ``linear``, ``fc2`` and the tail's and
shortcut's convs with their Mish fused.  The depthwise conv, the 1x1 convs
and the layer norm (eps 1e-6) stay plain torch.  The weights are packed
once per compute dtype (``prepare``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import dysample_scale, get_seq_len, pixelshuffle_scale
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.upsample import dysample
from ..ops.conv_route import conv, prepare_convs


@dataclass(frozen=True)
class MoSRConfig:
    in_ch: int
    out_ch: int
    n_block: int
    upscale: int
    dim: int
    upsampler: str  # 'ps' | 'dys' | 'gps'
    expansion_ratio: float
    conv_ratio: float
    kernel_size: int


def gated_cnn_block(p: PTree, x, dim: int, expansion_ratio: float, conv_ratio: float, ln_eps: float = 1e-6):
    """MambaOut gated CNN block (mosr/arch.py:72-106), Mish."""
    shortcut = x
    x = F.layer_norm(x, p['norm.weight'], p['norm.bias'], eps=ln_eps)
    hidden = int(expansion_ratio * dim)
    conv_channels = int(conv_ratio * dim)
    x = conv(p['fc1'], x)
    g = x[..., :hidden]
    i = x[..., hidden : 2 * hidden - conv_channels]
    c = conv(p['conv'], x[..., 2 * hidden - conv_channels :])  # depthwise: F.conv2d reads the slice
    x = conv(p['fc2'], F.mish(g) * torch.cat([i, c], dim=-1), 'mish')
    return x + (shortcut - 0.5)


def _conv_block_shortcut(p: PTree, x):
    """ConvBlock (mosr/arch.py:49-69)."""
    out1 = conv(p['block.0'], x, 'mish')
    out1 = conv(p['block.2'], out1, 'mish')
    return out1 + conv(p['conv11'], x)


def _gps(p: PTree, x, scale: int):
    """Geo-ensemble pixel shuffle (mosr/arch.py:8-32)."""
    x = conv(p['in_to_k'], x)
    n, h, w, c = x.shape
    # torch reshape (N, 8, C/8, H, W): NHWC channel split [8, c//8]
    x = x.reshape(n, h, w, 8, c // 8).mean(dim=3)
    return F.pixel_shuffle(x, scale)


def prepare(cfg: MoSRConfig, params, dtype):
    """The convs for ``dtype``; each block's depthwise conv has groups =
    its channels."""
    cc = int(cfg.conv_ratio * cfg.dim)
    return prepare_convs(params, dtype, {f'gblocks.{i}.conv': cc for i in range(1, cfg.n_block + 1)})


def apply(cfg: MoSRConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    out = conv(p['gblocks.0'], x)
    for i in range(cfg.n_block):
        out = gated_cnn_block(p.sub(f'gblocks.{i + 1}'), out, cfg.dim, cfg.expansion_ratio, cfg.conv_ratio)
    # tail: conv3x3 -> mish -> conv3x3 -> mish -> conv1x1 (arch.py:133)
    i0 = cfg.n_block + 1
    out = conv(p[f'gblocks.{i0}'], out, 'mish')
    out = conv(p[f'gblocks.{i0 + 2}'], out, 'mish')
    out = conv(p[f'gblocks.{i0 + 4}'], out)

    out = out + (_conv_block_shortcut(p.sub('shortcut'), x) - 0.5)

    if cfg.upsampler == 'ps':
        return F.pixel_shuffle(conv(p['upsampler.0'], out), cfg.upscale)
    if cfg.upsampler == 'dys':
        return dysample(p.sub('upsampler'), out, cfg.upscale)
    return _gps(p.sub('upsampler'), out, cfg.upscale)


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/mosr.py::_load``."""
    n_block = get_seq_len(sd, 'gblocks') - 6
    in_ch = sd['gblocks.0.weight'].shape[1]
    dim = sd['gblocks.0.weight'].shape[0]
    expansion_ratio = (sd['gblocks.1.fc1.weight'].shape[0] / sd['gblocks.1.fc1.weight'].shape[1]) / 2
    conv_ratio = sd['gblocks.1.conv.weight'].shape[0] / dim
    kernel_size = sd['gblocks.1.conv.weight'].shape[2]

    if 'upsampler.init_pos' in sd:
        upsampler = 'dys'
        out_ch = sd['upsampler.end_conv.weight'].shape[0]
        upscale = dysample_scale(sd['upsampler.offset.weight'].shape[0])
    elif 'upsampler.in_to_k.weight' in sd:
        upsampler = 'gps'
        out_ch = in_ch
        upscale = math.isqrt(sd['upsampler.in_to_k.weight'].shape[0] // 8 // out_ch)
    else:
        upsampler = 'ps'
        out_ch = in_ch
        upscale = pixelshuffle_scale(sd['upsampler.0.weight'].shape[0], out_ch)

    cfg = MoSRConfig(
        in_ch=in_ch, out_ch=out_ch, n_block=n_block, upscale=upscale, dim=dim,
        upsampler=upsampler, expansion_ratio=expansion_ratio, conv_ratio=conv_ratio,
        kernel_size=kernel_size,
    )
    meta = ModelMetadata(in_channels=in_ch, out_channels=out_ch, upscale=upscale, name='MoSR')
    return SRModel('MoSR', cfg, params_from_numpy(sd, device), meta, apply, prepare)


ARCH = Architecture(
    id='MoSR',
    detect_condition=KeyCondition.has_all(
        'gblocks.0.weight',
        'gblocks.0.bias',
        'gblocks.1.norm.weight',
        'gblocks.1.norm.bias',
        'gblocks.1.fc1.weight',
        'gblocks.1.fc1.bias',
        'gblocks.1.conv.weight',
        'gblocks.1.conv.bias',
        'gblocks.1.fc2.weight',
        'gblocks.1.fc2.bias',
    ),
    load_fn=_load,
)
