"""SwinIR — Image Restoration Using Swin Transformer.

Counterpart of ``resselt_tpu/archs/swinir.py``: the same config inference
(kept verbatim, including ``img_range = 255 iff window_size == 7``), the
same serving hints and the same forward, NHWC.  Every block's window
attention runs through ``ops.window_mha`` (on the card:
``csrc/window_attn.cu``, one launch per Swin block: 36 per SwinIR-M
forward), reading q, k and v in place from the qkv projection.  ``prepare``
casts the params to the compute dtype once, and gathers each block's
relative-position bias from its table once; the shift masks are built once
per geometry and device.  The linears, layer norms, gelu, roll, window
partition and convs are plain PyTorch, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_pixelshuffle_params, get_seq_len
from ..nn import functional as F
from ..nn.params import MEAN, PTree, cast_params, input_mean
from ..nn.window import relative_position_bias, shift_mask, swin_window_attention, window_partition, window_reverse

_RGB_MEAN = (0.4488, 0.4371, 0.4040)
_MASKS = 'shift_masks'  # prepare's key for the shift-mask cache


@dataclass(frozen=True)
class SwinIRConfig:
    img_size: int
    in_chans: int
    embed_dim: int
    depths: tuple[int, ...]
    num_heads: tuple[int, ...]
    window_size: int
    mlp_ratio: float
    upscale: int
    img_range: float
    upsampler: str
    resi_connection: str
    start_unshuffle: int
    num_out_ch: int


def swin_block(p: PTree, x, num_heads: int, window_size: int, shift_size: int,
               input_resolution: tuple[int, int], masks: dict, ln_eps: float = 1e-5):
    """SwinTransformerBlock on an NHWC map.  As in the reference
    constructor: if min(input_resolution) <= window_size, shift is disabled
    and the window shrinks to min(input_resolution).  ``masks`` caches the
    shift masks (:func:`shift_mask`)."""
    h, w = x.shape[1], x.shape[2]
    if min(input_resolution) <= window_size:
        shift_size = 0
        window_size = min(input_resolution)

    shortcut = x
    x = p.layer_norm('norm1', x, eps=ln_eps)
    if shift_size > 0:
        x = torch.roll(x, shifts=(-shift_size, -shift_size), dims=(1, 2))
    windows = window_partition(x, window_size)
    mask = shift_mask(masks, h, w, window_size, shift_size, x.device)
    attn = swin_window_attention(p.sub('attn'), windows, num_heads, mask=mask)
    x = window_reverse(attn, window_size, h, w)
    if shift_size > 0:
        x = torch.roll(x, shifts=(shift_size, shift_size), dims=(1, 2))
    x = shortcut + x

    y = p.layer_norm('norm2', x, eps=ln_eps)
    y = p.linear('mlp.fc2', F.gelu(p.linear('mlp.fc1', y)))
    return x + y


def _resi_conv(p: PTree, key: str, x, resi_connection: str):
    if resi_connection == '1conv':
        return p.conv(key, x, padding=1)
    q = p.sub(key)
    x = F.leaky_relu(q.conv('0', x, padding=1), 0.2)
    x = F.leaky_relu(q.conv('2', x), 0.2)
    return q.conv('4', x, padding=1)


def prepare(cfg: SwinIRConfig, params, dtype: torch.dtype) -> dict:
    """The params in ``dtype``, plus each block's relative-position bias
    under ``...attn.relative_position_bias`` ((heads, N, N), rounded to
    ``dtype``, held in f32 for the kernel) and an empty shift-mask cache."""
    out = cast_params(params, dtype)
    for li, depth in enumerate(cfg.depths):
        for bi in range(depth):
            a = f'layers.{li}.residual_group.blocks.{bi}.attn'
            out[f'{a}.relative_position_bias'] = relative_position_bias(
                params[f'{a}.relative_position_bias_table'], params[f'{a}.relative_position_index'], dtype)
    out[_MASKS] = {}
    out[MEAN] = input_mean(params, _RGB_MEAN if cfg.in_chans == 3 else (0.0,), dtype)
    return out


def apply(cfg: SwinIRConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    masks = params[_MASKS]
    h0, w0 = x.shape[1], x.shape[2]
    x = F.pad_to_multiple(x, cfg.window_size)

    mean = params[MEAN]
    x = (x - mean) * cfg.img_range

    if cfg.start_unshuffle > 1:
        x = F.interpolate_bicubic(x, scale_factor=cfg.start_unshuffle)
        x = F.pixel_unshuffle(x, cfg.start_unshuffle).contiguous()

    res = (cfg.img_size, cfg.img_size)

    def features(feat):
        if 'patch_embed.norm.weight' in p:
            feat = p.layer_norm('patch_embed.norm', feat)
        for li, depth in enumerate(cfg.depths):
            lp = p.sub(f'layers.{li}')
            y = feat
            for bi in range(depth):
                shift = 0 if bi % 2 == 0 else cfg.window_size // 2
                y = swin_block(lp.sub(f'residual_group.blocks.{bi}'), y, cfg.num_heads[li],
                               cfg.window_size, shift, res, masks)
            y = _resi_conv(lp, 'conv', y, cfg.resi_connection)
            feat = feat + y
        return p.layer_norm('norm', feat)

    if cfg.upsampler in ('pixelshuffle', 'pixelshuffledirect', 'nearest+conv'):
        x = p.conv('conv_first', x, padding=1)
        x = _resi_conv(p, 'conv_after_body', features(x), cfg.resi_connection) + x
        if cfg.upsampler == 'pixelshuffle':
            x = F.leaky_relu(p.conv('conv_before_upsample.0', x, padding=1), 0.01)
            if cfg.upscale & (cfg.upscale - 1) == 0:
                for i in range(int(math.log2(cfg.upscale))):
                    x = F.pixel_shuffle(p.conv(f'upsample.{2 * i}', x, padding=1), 2)
            elif cfg.upscale == 3:
                x = F.pixel_shuffle(p.conv('upsample.0', x, padding=1), 3)
            x = p.conv('conv_last', x, padding=1)
        elif cfg.upsampler == 'pixelshuffledirect':
            x = F.pixel_shuffle(p.conv('upsample.0', x, padding=1), cfg.upscale)
        else:  # nearest+conv
            x = F.leaky_relu(p.conv('conv_before_upsample.0', x, padding=1), 0.01)
            x = F.leaky_relu(p.conv('conv_up1', F.interpolate_nearest(x, 2), padding=1), 0.2)
            if cfg.upscale == 4:
                x = F.leaky_relu(p.conv('conv_up2', F.interpolate_nearest(x, 2), padding=1), 0.2)
            elif cfg.upscale == 8:
                x = F.leaky_relu(p.conv('conv_up2', F.interpolate_nearest(x, 2), padding=1), 0.2)
                x = F.leaky_relu(p.conv('conv_up3', F.interpolate_nearest(x, 2), padding=1), 0.2)
            x = p.conv('conv_last', F.leaky_relu(p.conv('conv_hr', x, padding=1), 0.2), padding=1)
    else:
        x_first = p.conv('conv_first', x, padding=1)
        res_f = _resi_conv(p, 'conv_after_body', features(x_first), cfg.resi_connection) + x_first
        x = x + p.conv('conv_last', res_f, padding=1)

    x = x / cfg.img_range + mean
    return x[:, : h0 * cfg.upscale, : w0 * cfg.upscale].contiguous()


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/swinir.py::_load``."""
    sd = dict(sd)
    start_unshuffle = 1

    if 'conv_before_upsample.0.weight' in sd:
        upsampler = 'nearest+conv' if 'conv_up1.weight' in sd else 'pixelshuffle'
    elif 'upsample.0.weight' in sd:
        upsampler = 'pixelshuffledirect'
    else:
        upsampler = ''

    if 'conv_first.1.weight' in sd:
        sd['conv_first.weight'] = sd.pop('conv_first.1.weight')
        sd['conv_first.bias'] = sd.pop('conv_first.1.bias')
        start_unshuffle = round(math.sqrt(sd['conv_first.weight'].shape[1] // 3))

    num_in_ch = sd['conv_first.weight'].shape[1]
    num_out_ch = sd['conv_last.weight'].shape[0] if 'conv_last.weight' in sd else num_in_ch

    upscale = 1
    if upsampler == 'nearest+conv':
        upscale = 2 ** len([x for x in sd if 'conv_up' in x and 'bias' not in x])
    elif upsampler == 'pixelshuffle':
        upscale, _num_feat = get_pixelshuffle_params(sd, 'upsample')
    elif upsampler == 'pixelshuffledirect':
        upscale = int(math.sqrt(sd['upsample.0.bias'].shape[0] // num_out_ch))

    embed_dim = sd['conv_first.weight'].shape[0]
    mlp_ratio = float(sd['layers.0.residual_group.blocks.0.mlp.fc1.bias'].shape[0] / embed_dim)
    window_size = int(math.sqrt(sd['layers.0.residual_group.blocks.0.attn.relative_position_index'].shape[0]))

    img_size = 64
    if 'layers.0.residual_group.blocks.1.attn_mask' in sd:
        img_size = int(math.sqrt(sd['layers.0.residual_group.blocks.1.attn_mask'].shape[0]) * window_size)

    num_layers = get_seq_len(sd, 'layers')
    depths, num_heads = [], []
    for i in range(num_layers):
        depths.append(get_seq_len(sd, f'layers.{i}.residual_group.blocks'))
        num_heads.append(sd[f'layers.{i}.residual_group.blocks.0.attn.relative_position_bias_table'].shape[1])

    resi_connection = '1conv' if 'conv_after_body.weight' in sd else '3conv'
    img_range = 255.0 if window_size == 7 else 1.0
    in_nc = num_in_ch // start_unshuffle**2

    cfg = SwinIRConfig(
        img_size=img_size, in_chans=in_nc, embed_dim=embed_dim, depths=tuple(depths),
        num_heads=tuple(num_heads), window_size=window_size, mlp_ratio=mlp_ratio,
        upscale=upscale, img_range=img_range, upsampler=upsampler,
        resi_connection=resi_connection, start_unshuffle=start_unshuffle,
        num_out_ch=num_out_ch,
    )
    params = {k: v for k, v in sd.items() if not k.endswith('.attn_mask')}
    meta = ModelMetadata(in_channels=in_nc, out_channels=num_out_ch, upscale=upscale, name='SwinIR')
    model = SRModel('SwinIR', cfg, params_from_numpy(params, device), meta, apply, prepare)
    # the JAX package's hints, kept so that tiled outputs match it; their
    # values have not been re-measured on a GPU
    model.tile_batch = 1
    model.serving_tile = {'f32': 112, 'bf16': 160}
    model.serving_halo = 8
    model.size_multiple = window_size  # window-aligned derived halos off-hint
    return model


ARCH = Architecture(
    id='SwinIR',
    detect_condition=KeyCondition.has_all(
        'layers.0.residual_group.blocks.0.norm1.weight',
        'conv_first.weight',
        'layers.0.residual_group.blocks.0.mlp.fc1.bias',
        'layers.0.residual_group.blocks.0.attn.relative_position_index',
    ),
    load_fn=_load,
)
