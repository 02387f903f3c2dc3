"""FlexNet: a multi-scale window ViT with a linear or a U-shaped pipeline.

Counterpart of ``resselt_tpu/archs/flexnet.py``: the same config inference
(the scalar ``window_size`` / ``scale_factor`` buffers read and dropped),
metadata and forward.  Transformer blocks of LMLTVIT window attention
(one head over the full width, scale C^-1/2, a LePE depthwise 3x3 on v)
and an RWKV-style ChannelMix FFN (relu², optional RMSNorm, sigmoid gate),
each after a bias-free OmniShift collapsed at load into one depthwise 5x5;
ConvBlocks; the ``ps`` / ``n+c`` / ``dys`` tails.  The window attention
runs through ``ops.window_mha`` (``csrc/window_attn.cu``) with a zero
one-head bias at every level (head_dim = C: 64 and below on the kernel's
first pair, the meta pipeline's wider levels on its "any" kernels).  The
kernel keeps the scores in f32, where the JAX package rounds them to the
input's dtype before the softmax; in f32 the two agree.  Every same-padded 3x3 conv with
groups 1 runs through ``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``), the
ConvBlocks' with their Mish fused, the meta pipeline's bias-free ``down`` /
``up`` convs and the tails' too.  The weights are built once per compute
dtype (``prepare``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.reparam import pad_kernel_to
from ..nn.upsample import dysample
from ..nn.window import multi_head_attention
from ..ops.conv_route import conv, prepare_convs

_F32_EPS = float(np.finfo(np.float32).eps)
_ZERO_BIAS = 'attention_zero_bias'  # prepare's key for the (1, ws², ws²) f32 zero bias


@dataclass(frozen=True)
class FlexNetConfig:
    inp_channels: int
    out_channels: int
    scale: int
    dim: int
    num_blocks: tuple[int, ...]
    window_size: int
    hidden_rate: int
    channel_norm: bool
    pipeline_type: str  # 'linear' | 'meta'
    upsampler: str  # 'ps' | 'dys' | 'n+c'


def flexnet_omnishift_collapse(sd, prefix: str):
    """Bias-free OmniShift with one alpha vector (reference
    flexnet/arch.py:66-130) as one depthwise 5x5 weight (numpy)."""
    a = np.asarray(sd[f'{prefix}.alpha'], np.float64)
    w1 = np.asarray(sd[f'{prefix}.conv1x1.weight'], np.float64)
    w3 = np.asarray(sd[f'{prefix}.conv3x3.weight'], np.float64)
    w5 = np.asarray(sd[f'{prefix}.conv5x5.weight'], np.float64)
    ident = pad_kernel_to(np.ones_like(w1), 5)
    w = a[0] * ident + a[1] * pad_kernel_to(w1, 5) + a[2] * pad_kernel_to(w3, 5) + a[3] * w5
    return w.astype(np.float32)


def _rms(p: PTree, name: str, x):
    return F.rms_norm(x, p[f'{name}.weight'], eps=_F32_EPS)


def _windows(t, h: int, w: int, ws: int):
    """(B, H*W, C) or (B, H, W, C) -> (B * nW, ws², C) windows."""
    b, c = t.shape[0], t.shape[-1]
    return t.reshape(b, h // ws, ws, w // ws, ws, c).transpose(2, 3).reshape(-1, ws * ws, c)


def _lmltvit(p: PTree, x, h: int, w: int, ws: int, bias):
    """LMLTVIT (flexnet/arch.py:137-229) on ``x`` (B, N, C)."""
    b, n, c = x.shape
    img = conv(p['omni_shift.conv5x5_reparam'], x.reshape(b, h, w, c))
    qkv = p.linear('qkv', _windows(img, h, w, ws))
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    lepe = conv(p['get_v'], v.reshape(-1, ws, ws, c)).reshape(-1, ws * ws, c)
    out = multi_head_attention(q, k, v, 1, c**-0.5, bias=bias) + lepe
    out = p.linear('proj', out)
    return out.reshape(b, h // ws, w // ws, ws, ws, c).transpose(2, 3).reshape(b, n, c)


def _channel_mix(p: PTree, x, h: int, w: int, channel_norm: bool):
    """ChannelMix (flexnet/arch.py:232-263) on ``x`` (B, N, C)."""
    b, n, c = x.shape
    x = conv(p['omni_shift.conv5x5_reparam'], x.reshape(b, h, w, c)).reshape(b, n, c)
    k = F.relu(p.linear('key', x)).square()
    if channel_norm:
        k = F.rms_norm(k, p['key_norm.weight'], eps=_F32_EPS)
    return F.sigmoid(p.linear('receptance', x)) * p.linear('value', k)


def _t_block(p: PTree, x, h: int, w: int, cfg: FlexNetConfig, bias):
    """TransformerBlock (flexnet/arch.py:266-285)."""
    x = x + p['gamma1'].to(x.dtype) * _lmltvit(p.sub('att'), _rms(p, 'rn1', x), h, w, cfg.window_size, bias)
    return x + p['gamma2'].to(x.dtype) * _channel_mix(p.sub('ffn'), _rms(p, 'rn2', x), h, w, cfg.channel_norm)


def _conv_block(p: PTree, x):
    """ConvBlock (flexnet/arch.py:43-63) on NHWC ``x``."""
    return conv(p['block.2'], conv(p['block.0'], x, 'mish'), 'mish') + conv(p['conv11'], x)


def _xblock(p: PTree, x_img, n_block: int, cfg: FlexNetConfig, bias):
    """LBlock / MBlock (flexnet/arch.py:288-339) on NHWC ``x_img``."""
    b, h, w, c = x_img.shape
    x = x_img.reshape(b, h * w, c)
    shortcut = x
    for i in range(n_block):
        x = _t_block(p.sub(f't_blocks.{i}'), x, h, w, cfg, bias)
    return _conv_block(p.sub('conv'), torch.cat([shortcut, x], dim=-1).reshape(b, h, w, 2 * c))


def prepare(cfg: FlexNetConfig, params, dtype):
    """The convs for ``dtype`` (the OmniShifts and LePE convs are
    depthwise) and the attentions' zero bias."""
    groups = {k[: -len('.weight')]: v.shape[0] for k, v in params.items()
              if k.endswith(('.conv5x5_reparam.weight', '.get_v.weight'))}
    out = prepare_convs(params, dtype, groups)
    n = cfg.window_size**2
    out[_ZERO_BIAS] = torch.zeros((1, n, n), dtype=torch.float32, device=next(iter(params.values())).device)
    return out


def apply(cfg: FlexNetConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``."""
    p = PTree(w)
    bias = w[_ZERO_BIAS]
    h0, w0 = x.shape[1], x.shape[2]
    x = F.pad_to_multiple(x, cfg.window_size * (8 if cfg.pipeline_type == 'meta' else 1), mode='reflect')

    short_cut = _conv_block(p.sub('short_cut'), x)
    x = conv(p['in_to_feat'], x)
    nb = cfg.num_blocks
    if cfg.pipeline_type == 'linear':
        for i, n in enumerate(nb):
            x = _xblock(p.sub(f'pipeline.att.{i}'), x, n, cfg, bias)
    else:
        pp = p.sub('pipeline')

        def down(name, t):
            return F.pixel_unshuffle(conv(pp[f'{name}.body.0'], t), 2)

        def up(name, t):
            return F.pixel_shuffle(conv(pp[f'{name}.body.0'], t), 2)

        enc0 = down('down1', _xblock(pp.sub('enc0.0'), x, nb[0], cfg, bias))
        enc1 = down('down2', _xblock(pp.sub('enc1.0'), enc0, nb[1], cfg, bias))
        enc2 = down('down3', _xblock(pp.sub('enc2.0'), enc1, nb[2], cfg, bias))
        enc3 = _xblock(pp.sub('enc3.0'), enc2, nb[3], cfg, bias)
        y = _xblock(pp.sub('dec0.0'), up('up1', torch.cat([enc3, enc2], dim=-1)), nb[2], cfg, bias)
        y = _xblock(pp.sub('dec1.0'), up('up2', torch.cat([y, enc1], dim=-1)), nb[1], cfg, bias)
        x = _xblock(pp.sub('dec2.0'), up('up3', torch.cat([y, enc0], dim=-1)), nb[0], cfg, bias)
    x = torch.cat([x, short_cut], dim=-1)

    if cfg.upsampler == 'n+c':
        x = conv(p['to_img.0'], x)
        q = p.sub('to_img.1')
        if cfg.scale & (cfg.scale - 1) == 0:
            idx = 0
            for _ in range(int(math.log2(cfg.scale))):
                x = F.leaky_relu(F.interpolate_nearest(conv(q[str(idx)], x), scale_factor=2), 0.2)
                idx += 3
            x = conv(q[str(idx + 2)], conv(q[str(idx)], x, 'lrelu'))
        else:
            x = F.leaky_relu(F.interpolate_nearest(conv(q['0'], x), scale_factor=3), 0.2)
            x = conv(q['5'], conv(q['3'], x, 'lrelu'))
    elif cfg.upsampler == 'dys':
        x = dysample(p.sub('to_img'), x, cfg.scale)
    else:
        x = F.pixel_shuffle(conv(p['to_img.0'], x), cfg.scale)
    return x[:, : h0 * cfg.scale, : w0 * cfg.scale]


def transform_params(sd) -> dict:
    """Collapse every OmniShift (found by ``.conv1x1.weight``) into
    ``{prefix}.conv5x5_reparam.weight`` (numpy)."""
    prefixes = sorted({k[: -len('.conv1x1.weight')] for k in sd if k.endswith('.conv1x1.weight')})
    out = {f'{prefix}.conv5x5_reparam.weight': flexnet_omnishift_collapse(sd, prefix) for prefix in prefixes}
    consumed = tuple(prefix + '.' for prefix in prefixes)
    out.update({k: v for k, v in sd.items() if not k.startswith(consumed)})
    return out


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/flexnet.py::_load``."""
    window_size = int(np.asarray(sd['window_size']).reshape(-1)[0])
    dim, inp_channels = sd['in_to_feat.weight'].shape[:2]
    out_channels = inp_channels

    if 'pipeline.enc0.0.t_blocks.0.gamma1' in sd:
        pipeline_type = 'meta'
        num_blocks = tuple(get_seq_len(sd, f'pipeline.enc{i}.0.t_blocks') for i in range(4))
        hr_shape = sd['pipeline.enc0.0.t_blocks.0.ffn.key.weight'].shape
        channel_norm = 'pipeline.enc0.0.t_blocks.0.ffn.key_norm.weight' in sd
    else:
        pipeline_type = 'linear'
        n = get_seq_len(sd, 'pipeline.att')
        num_blocks = tuple(get_seq_len(sd, f'pipeline.att.{i}.t_blocks') for i in range(n))
        hr_shape = sd['pipeline.att.0.t_blocks.2.ffn.key.weight'].shape
        channel_norm = 'pipeline.att.0.t_blocks.0.ffn.key_norm.weight' in sd

    if 'to_img.1.0.weight' in sd:
        upsampler = 'n+c'
        scale = int(np.asarray(sd['scale_factor']).reshape(-1)[0])
        out_channels = sd[f'to_img.1.{get_seq_len(sd, "to_img.1") - 1}.weight'].shape[0]
    elif 'to_img.init_pos' in sd:
        upsampler = 'dys'
        out_channels = sd['to_img.end_conv.weight'].shape[0]
        scale = math.isqrt(sd['to_img.offset.weight'].shape[0] // 8)
    else:
        upsampler = 'ps'
        scale = math.isqrt(sd['to_img.0.weight'].shape[0] // out_channels)

    cfg = FlexNetConfig(inp_channels=inp_channels, out_channels=out_channels, scale=scale, dim=dim,
                        num_blocks=num_blocks, window_size=window_size, hidden_rate=hr_shape[0] // hr_shape[1],
                        channel_norm=channel_norm, pipeline_type=pipeline_type, upsampler=upsampler)
    params = {k: v for k, v in transform_params(sd).items() if k not in ('window_size', 'scale_factor')}
    meta = ModelMetadata(in_channels=inp_channels, out_channels=out_channels, upscale=scale, name='FlexNet')
    return SRModel('FlexNet', cfg, params_from_numpy(params, device), meta, apply, prepare)


ARCH = Architecture(
    id='FlexNet',
    detect_condition=KeyCondition.has_all(
        'short_cut.block.0.weight',
        'short_cut.block.0.bias',
        'short_cut.block.2.weight',
        'short_cut.block.2.bias',
        'short_cut.conv11.weight',
        'short_cut.conv11.bias',
        'in_to_feat.weight',
        'in_to_feat.bias',
        KeyCondition.has_any(
            'pipeline.enc0.0.t_blocks.0.gamma1',
            'pipeline.att.0.t_blocks.0.gamma1',
        ),
    ),
    load_fn=_load,
)
