"""DRCT — Dense Residual Connected Transformer.

Counterpart of ``resselt_tpu/archs/drct.py``: the same config inference
(kept verbatim), the same serving hints and the same forward, NHWC:
residual dense groups (RDGs) of five Swin blocks, each block's input the
concatenation of the group's input and the earlier blocks' outputs, each
output narrowed to ``gc`` channels by a 1x1 conv, the fifth back to the
embedding.  The Swin blocks are the port's ``swinir.swin_block``; block
k of a group runs on ``embed + (k - 1) * gc`` channels with ``heads -
width % heads`` heads, the second and fourth shifted.

On the card each block's window attention whose head_dim is at most 64
runs through ``ops.window_mha`` (``csrc/window_attn.cu``, q, k and v read in
place from the qkv projection); at DRCT's width (embed 180, gc 32, 6 heads)
those are blocks 1, 2 and 4, while blocks 3 (2 heads of 122) and 5 (4 of
77) take the plain path of ``nn.window.multi_head_attention``, where it
counts them.  ``prepare`` casts the params once per dtype and gathers
every block's relative-position bias once; the shift masks are built once
per geometry and device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_pixelshuffle_params, get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.window import relative_position_bias
from .swinir import swin_block

_RGB_MEAN = (0.4488, 0.4371, 0.4040)
_MASKS = 'shift_masks'  # prepare's key for the shift-mask cache


@dataclass(frozen=True)
class DRCTConfig:
    in_chans: int
    embed_dim: int
    num_layers: int
    num_heads: tuple[int, ...]
    window_size: int
    gc: int
    upscale: int
    img_range: float
    upsampler: str
    resi_connection: str
    img_size: int


def _rdg(p: PTree, x, cfg: DRCTConfig, heads: int, masks: dict):
    """A residual dense group of five Swin blocks."""
    res = (cfg.img_size, cfg.img_size)
    ws, d, gc = cfg.window_size, cfg.embed_dim, cfg.gc
    feats = [x]
    for k in range(1, 6):
        width = d + (k - 1) * gc
        y = swin_block(p.sub(f'swin{k}'), torch.cat(feats, dim=-1) if k > 1 else x,
                       heads if k == 1 else heads - width % heads, ws, ws // 2 if k in (2, 4) else 0, res, masks)
        y = p.conv(f'adjust{k}', y)
        feats.append(F.leaky_relu(y, 0.2) if k < 5 else y)
    return feats[5] * 0.2 + x


def prepare(cfg: DRCTConfig, params, dtype: torch.dtype) -> dict:
    """The params in ``dtype``, plus each block's relative-position bias
    under ``layers.{i}.swin{k}.attn.relative_position_bias`` ((heads, N, N),
    rounded to ``dtype``, held in f32 for the kernel) and an empty shift-mask
    cache."""
    out = {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
    for li in range(cfg.num_layers):
        for k in range(1, 6):
            a = f'layers.{li}.swin{k}.attn'
            out[f'{a}.relative_position_bias'] = relative_position_bias(
                params[f'{a}.relative_position_bias_table'], params[f'{a}.relative_position_index'], dtype)
    out[_MASKS] = {}
    return out


def apply(cfg: DRCTConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    masks = params[_MASKS]
    if cfg.in_chans == 3:
        mean = torch.tensor(_RGB_MEAN, dtype=x.dtype, device=x.device)
    else:
        mean = torch.zeros((1,), dtype=x.dtype, device=x.device)
    x = (x - mean) * cfg.img_range
    h0, w0 = x.shape[1], x.shape[2]
    x = F.pad_to_multiple(x, cfg.window_size)

    if cfg.upsampler == 'pixelshuffle':
        x = p.conv('conv_first', x, padding=1)
        feat = x
        if 'patch_embed.norm.weight' in p:
            feat = p.layer_norm('patch_embed.norm', feat)
        for li in range(cfg.num_layers):
            feat = _rdg(p.sub(f'layers.{li}'), feat, cfg, cfg.num_heads[li], masks)
        feat = p.layer_norm('norm', feat)
        if cfg.resi_connection == '1conv':
            feat = p.conv('conv_after_body', feat, padding=1)
        x = feat + x
        x = F.leaky_relu(p.conv('conv_before_upsample.0', x, padding=1), 0.01)
        if cfg.upscale & (cfg.upscale - 1) == 0:
            for i in range(int(math.log2(cfg.upscale))):
                x = F.pixel_shuffle(p.conv(f'upsample.{2 * i}', x, padding=1), 2)
        elif cfg.upscale == 3:
            x = F.pixel_shuffle(p.conv('upsample.0', x, padding=1), 3)
        x = p.conv('conv_last', x, padding=1)

    x = x / cfg.img_range + mean
    return x[:, : h0 * cfg.upscale, : w0 * cfg.upscale].contiguous()


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/drct.py::_load``."""
    in_chans = sd['conv_first.weight'].shape[1]
    embed_dim = sd['conv_first.weight'].shape[0]
    num_layers = get_seq_len(sd, 'layers')
    num_heads = tuple(
        sd[f'layers.{i}.swin1.attn.relative_position_bias_table'].shape[1] for i in range(num_layers)
    )
    window_square = sd['layers.0.swin1.attn.relative_position_bias_table'].shape[0]
    window_size = (math.isqrt(window_square) + 1) // 2

    if 'conv_last.weight' in sd:
        upsampler = 'pixelshuffle'
        upscale, _ = get_pixelshuffle_params(sd, 'upsample')
    else:
        upsampler = ''
        upscale = 1

    resi_connection = '1conv' if 'conv_after_body.weight' in sd else 'identity'
    gc = sd['layers.0.adjust1.weight'].shape[0]

    if 'layers.0.swin2.attn_mask' in sd:
        img_size = math.isqrt(sd['layers.0.swin2.attn_mask'].shape[0]) * window_size
    else:
        img_size = window_size

    cfg = DRCTConfig(
        in_chans=in_chans, embed_dim=embed_dim, num_layers=num_layers, num_heads=num_heads,
        window_size=window_size, gc=gc, upscale=upscale, img_range=1.0,
        upsampler=upsampler, resi_connection=resi_connection, img_size=img_size,
    )
    params = {k: v for k, v in sd.items() if not k.endswith('.attn_mask')}
    meta = ModelMetadata(in_channels=in_chans, out_channels=in_chans, upscale=upscale, name='DRCT')
    model = SRModel('DRCT', cfg, params_from_numpy(params, device), meta, apply, prepare)
    # the JAX package's hints, kept so that tiled outputs match it; their
    # values have not been re-measured on a GPU
    model.tile_batch = 1
    model.serving_tile = {'f32': 96, 'bf16': 128}
    model.serving_halo = 8
    model.size_multiple = window_size
    return model


ARCH = Architecture(
    id='DRCT',
    detect_condition=KeyCondition.has_all(
        'conv_first.weight',
        'conv_first.bias',
        'layers.0.swin1.norm1.weight',
        'layers.0.swin1.norm1.bias',
        'layers.0.swin1.attn.relative_position_bias_table',
        'layers.0.swin1.attn.relative_position_index',
        'layers.0.swin1.attn.qkv.weight',
        'layers.0.swin1.attn.proj.weight',
        'layers.0.swin1.attn.proj.bias',
        'layers.0.swin1.norm2.weight',
        'layers.0.swin1.mlp.fc1.weight',
        'layers.0.swin1.mlp.fc1.bias',
        'layers.0.swin1.mlp.fc2.weight',
        'layers.0.adjust1.weight',
        'layers.0.swin2.norm1.weight',
        'layers.0.adjust2.weight',
        'layers.0.swin3.norm1.weight',
        'layers.0.adjust3.weight',
        'layers.0.swin4.norm1.weight',
        'layers.0.adjust4.weight',
        'layers.0.swin5.norm1.weight',
        'layers.0.adjust5.weight',
        'norm.weight',
        'norm.bias',
    ),
    load_fn=_load,
)
