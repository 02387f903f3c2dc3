"""HAT — Hybrid Attention Transformer.

Counterpart of ``resselt_tpu/archs/hat.py``: the same config inference
(kept verbatim), the same serving hints and the same forward, NHWC: hybrid
attention blocks (shifted-window attention plus a channel-attention conv
branch), one overlapping cross-attention block (OCAB) per group, a
pixelshuffle tail.  The two relative-position index buffers come from the
checkpoint.

On the card every block's window attention runs through ``ops.window_mha``
(``csrc/window_attn.cu``, q, k and v read in place from the qkv
projection: one launch per block).  OCAB attends from a window's N queries
to the M > N keys of a larger overlapping window, which the kernel does
not take: it runs the plain path of ``nn.window.multi_head_attention``, as
in the JAX package.  ``prepare`` casts the params once per dtype and
gathers every relative-position bias once; the shift masks are built once
per geometry and device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as TF

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_pixelshuffle_params, get_seq_len
from ..nn import functional as F
from ..nn.params import MEAN, PTree, cast_params, input_mean
from ..nn.window import (
    multi_head_attention,
    relative_position_bias,
    shift_mask,
    swin_window_attention,
    window_partition,
    window_reverse,
)

_RGB_MEAN = (0.4488, 0.4371, 0.4040)
_MASKS = 'shift_masks'  # prepare's key for the shift-mask cache


@dataclass(frozen=True)
class HATConfig:
    in_chans: int
    embed_dim: int
    depths: tuple[int, ...]
    num_heads: tuple[int, ...]
    window_size: int
    overlap_win_size: int
    compress_ratio: float
    squeeze_factor: float
    conv_scale: float
    mlp_ratio: float
    qkv_bias: bool
    upscale: int
    img_range: float
    resi_connection: str
    num_feat: int
    img_size: int


def _cab(p: PTree, x):
    """Channel attention conv block: conv, gelu, conv, then a squeeze and
    excitation over the image's mean."""
    y = F.gelu(p.conv('cab.0', x, padding=1))
    y = p.conv('cab.2', y, padding=1)
    a = y.mean(dim=(1, 2), keepdim=True)
    a = F.relu(p.conv('cab.3.attention.1', a))
    a = F.sigmoid(p.conv('cab.3.attention.3', a))
    return y * a


def _hab(p: PTree, x, cfg: HATConfig, num_heads: int, shift: int, masks: dict):
    """Hybrid attention block on an NHWC map."""
    h, w = x.shape[1], x.shape[2]
    ws = cfg.window_size
    shortcut = x
    x = p.layer_norm('norm1', x)

    conv_x = _cab(p.sub('conv_block'), x)

    shifted = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift > 0 else x
    mask = shift_mask(masks, h, w, ws, shift, x.device)
    attn = swin_window_attention(p.sub('attn'), window_partition(shifted, ws), num_heads, mask=mask)
    shifted = window_reverse(attn, ws, h, w)
    attn_x = torch.roll(shifted, shifts=(shift, shift), dims=(1, 2)) if shift > 0 else shifted

    x = shortcut + attn_x + conv_x * cfg.conv_scale
    y = p.layer_norm('norm2', x)
    y = p.linear('mlp.fc2', F.gelu(p.linear('mlp.fc1', y)))
    return x + y


def _overlap_windows(kv, ws: int, owin: int):
    """Overlapping (owin, owin) windows at stride ws, zero-padded:
    ``nn.Unfold(owin, stride=ws, padding=(owin - ws) // 2)`` on an NHWC
    map.  Returns (b * nwin, owin * owin, c), windows and the positions
    inside them in row-major order."""
    b, h, w, c = kv.shape
    pad = (owin - ws) // 2
    kvp = TF.pad(kv, (0, 0, pad, pad, pad, pad))
    wins = kvp.unfold(1, owin, ws).unfold(2, owin, ws)  # (b, ni, nj, c, owin, owin)
    return wins.permute(0, 1, 2, 4, 5, 3).reshape(-1, owin * owin, c)


def _ocab(p: PTree, x, cfg: HATConfig, num_heads: int):
    """Overlapping cross-attention block: a window's queries attend to the
    keys of the larger window around it."""
    h, w = x.shape[1], x.shape[2]
    ws = cfg.window_size
    c = cfg.embed_dim

    shortcut = x
    x = p.layer_norm('norm1', x)
    qkv = p.linear('qkv', x)
    q_windows = window_partition(qkv[..., :c], ws)  # (b*nw, ws*ws, c)
    patches = _overlap_windows(qkv[..., c:], ws, cfg.overlap_win_size)  # (b*nw, owin*owin, 2c)

    scale = (c // num_heads) ** -0.5
    out = multi_head_attention(q_windows, patches[..., :c], patches[..., c:], num_heads, scale,
                               bias=p['relative_position_bias'])
    out = window_reverse(out, ws, h, w)

    x = p.linear('proj', out) + shortcut
    y = p.layer_norm('norm2', x)
    y = p.linear('mlp.fc2', F.gelu(p.linear('mlp.fc1', y)))
    return x + y


def prepare(cfg: HATConfig, params, dtype: torch.dtype) -> dict:
    """The params in ``dtype``, plus every attention's relative-position
    bias under ``....relative_position_bias`` (the blocks': (heads, N, N);
    the OCABs': (heads, N, M); rounded to ``dtype``, held in f32) and an
    empty shift-mask cache."""
    out = cast_params(params, dtype)
    rpi_sa = params['relative_position_index_SA']
    rpi_oca = params['relative_position_index_OCA']
    for li, depth in enumerate(cfg.depths):
        g = f'layers.{li}.residual_group'
        attns = [(f'{g}.blocks.{bi}.attn', rpi_sa) for bi in range(depth)] + [(f'{g}.overlap_attn', rpi_oca)]
        for a, rpi in attns:
            out[f'{a}.relative_position_bias'] = relative_position_bias(
                params[f'{a}.relative_position_bias_table'], rpi, dtype)
    out[_MASKS] = {}
    out[MEAN] = input_mean(params, _RGB_MEAN if cfg.in_chans == 3 else (0.0,), dtype)
    return out


def apply(cfg: HATConfig, params, x):
    """Forward on NHWC ``x`` with ``params = prepare(cfg, ..., x.dtype)``."""
    p = PTree(params)
    masks = params[_MASKS]
    h0, w0 = x.shape[1], x.shape[2]
    mean = params[MEAN]
    x = (x - mean) * cfg.img_range
    x = F.pad_to_multiple(x, cfg.window_size)

    x = p.conv('conv_first', x, padding=1)
    feat = x
    if 'patch_embed.norm.weight' in p:
        feat = p.layer_norm('patch_embed.norm', feat)
    for li, depth in enumerate(cfg.depths):
        lp = p.sub(f'layers.{li}')
        y = feat
        for bi in range(depth):
            shift = 0 if bi % 2 == 0 else cfg.window_size // 2
            y = _hab(lp.sub(f'residual_group.blocks.{bi}'), y, cfg, cfg.num_heads[li], shift, masks)
        y = _ocab(lp.sub('residual_group.overlap_attn'), y, cfg, cfg.num_heads[li])
        if cfg.resi_connection == '1conv':
            y = lp.conv('conv', y, padding=1)
        feat = feat + y
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


def _get_overlap_ratio(window_size: int, with_overlap: int) -> float:
    """The overlap ratio whose overlapping window is ``with_overlap`` wide."""
    for ratio in [0, 1, 0.5, 0.25, 0.75, 0.1, 0.2, 0.3, 0.4, 0.6, 0.7, 0.8, 0.9]:
        if int(window_size + window_size * ratio) == with_overlap:
            return ratio
    return (with_overlap - window_size) / window_size + 0.01


def _inv_int_div(a: int, c: int) -> float:
    """A ``b`` with ``a // b == c``: the integer quotient where there is
    one, else the nearest float that divides back."""
    b_float = a / c
    if b_float.is_integer():
        return int(b_float)
    if c == a // math.ceil(b_float):
        return math.ceil(b_float)
    if c == a // math.floor(b_float):
        return math.floor(b_float)
    if c == a // b_float:
        return b_float
    if c == a // (b_float - 0.01):
        return b_float - 0.01
    if c == a // (b_float + 0.01):
        return b_float + 0.01
    raise ValueError(f'Could not find b with a // b == c. a={a}, c={c}')


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/hat.py::_load``."""
    in_chans = sd['conv_first.weight'].shape[1]
    embed_dim = sd['conv_first.weight'].shape[0]
    num_feat = sd['conv_last.weight'].shape[1]
    upscale, _ = get_pixelshuffle_params(sd, 'upsample', num_feat)

    window_size = int(math.sqrt(sd['relative_position_index_SA'].shape[0]))
    overlap_ratio = _get_overlap_ratio(
        window_size, with_overlap=int(math.sqrt(sd['relative_position_index_OCA'].shape[1]))
    )
    overlap_win_size = int(window_size * overlap_ratio) + window_size

    num_layers = get_seq_len(sd, 'layers')
    depths = tuple(get_seq_len(sd, f'layers.{i}.residual_group.blocks') for i in range(num_layers))
    num_heads = tuple(
        sd[f'layers.{i}.residual_group.overlap_attn.relative_position_bias_table'].shape[1]
        for i in range(num_layers)
    )

    resi_connection = '1conv' if 'conv_after_body.weight' in sd else 'identity'
    compress_ratio = _inv_int_div(embed_dim, sd['layers.0.residual_group.blocks.0.conv_block.cab.0.weight'].shape[0])
    squeeze_factor = _inv_int_div(
        embed_dim, sd['layers.0.residual_group.blocks.0.conv_block.cab.3.attention.1.weight'].shape[0]
    )
    qkv_bias = 'layers.0.residual_group.blocks.0.attn.qkv.bias' in sd
    mlp_hidden_dim = int(sd['layers.0.residual_group.blocks.0.mlp.fc1.weight'].shape[0])
    mlp_ratio = mlp_hidden_dim / embed_dim
    img_size = 64
    if 'absolute_pos_embed' in sd:
        img_size = int(math.sqrt(sd['absolute_pos_embed'].shape[1]))

    cfg = HATConfig(
        in_chans=in_chans, embed_dim=embed_dim, depths=depths, num_heads=num_heads,
        window_size=window_size, overlap_win_size=overlap_win_size,
        compress_ratio=compress_ratio, squeeze_factor=squeeze_factor, conv_scale=0.01,
        mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, upscale=upscale, img_range=1.0,
        resi_connection=resi_connection, num_feat=num_feat, img_size=img_size,
    )
    meta = ModelMetadata(in_channels=in_chans, out_channels=in_chans, upscale=upscale, name='HAT')
    model = SRModel('HAT', cfg, params_from_numpy(sd, device), meta, apply, prepare)
    # the JAX package's hints, kept so that tiled outputs match it; their
    # values have not been re-measured on a GPU
    model.tile_batch = 2
    model.serving_tile = 192
    model.serving_halo = 16
    model.size_multiple = window_size
    return model


ARCH = Architecture(
    id='HAT',
    detect_condition=KeyCondition.has_all(
        'relative_position_index_SA',
        'conv_first.weight',
        'layers.0.residual_group.blocks.0.norm1.weight',
        'layers.0.residual_group.blocks.0.conv_block.cab.0.weight',
        'layers.0.residual_group.blocks.0.conv_block.cab.2.weight',
        'layers.0.residual_group.blocks.0.conv_block.cab.3.attention.1.weight',
        'layers.0.residual_group.blocks.0.conv_block.cab.3.attention.3.weight',
        'layers.0.residual_group.blocks.0.mlp.fc1.bias',
        'layers.0.residual_group.blocks.0.mlp.fc2.weight',
        'layers.0.residual_group.overlap_attn.relative_position_bias_table',
        'layers.0.residual_group.overlap_attn.qkv.weight',
        'layers.0.residual_group.overlap_attn.proj.weight',
        'layers.0.residual_group.overlap_attn.mlp.fc1.weight',
        'layers.0.residual_group.overlap_attn.mlp.fc2.weight',
        'conv_last.weight',
    ),
    load_fn=_load,
)
