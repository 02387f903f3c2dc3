"""DRCT (classical SR, pixelshuffle tail, one-conv body residual), written
from the published ``basicsr/archs/DRCT_arch.py``, in plain float32 PyTorch
on NCHW images and (B, L, C) tokens.

A residual dense group (RDG) is five Swin blocks: block k takes the
concatenation of the group's input and the outputs of the blocks before it,
``embed + (k - 1) * gc`` channels, with ``heads - width % heads`` heads
(the first block ``heads``), the second and fourth shifted by half a window;
a 1x1 ``adjust`` conv narrows its output to ``gc`` channels (the fifth back
to ``embed``), lrelu 0.2 on the first four; the group returns 0.2 x the
fifth's output plus its input.  The Swin block is SwinIR's, so this module
takes it, the window partition, the shift mask, the relative-position index
and the layer norm from ``swinir_m_x4``.

Departures from the published code, none of which changes a value:
- tokens stay (B, L, C) between blocks, where the published RDG unembeds
  them to an image for each ``adjust`` conv and embeds them again
  (``PatchUnEmbed`` / ``PatchEmbed`` without a norm); the 1x1 conv is the
  same product as a linear on the tokens;
- the input is reflect-padded to a multiple of the window and the output
  cropped back, as the published inference wrapper pads a test image;
- an RDG's ``depth`` (6 in ``depths``) is read by nothing, as in the
  published RDG, which always holds five blocks.

The state dict uses the published key names, buffers included: every
block's ``attn.relative_position_index`` and the shifted blocks'
``attn_mask`` (built for ``img_size``, as the published constructor
registers it; the forward computes the mask for the size it is given).
The random weights are scaled as ``swinir_m_x4``'s, by each block's own
width, so that the attention is far from uniform.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .swinir_m_x4 import NUM_FEAT, RGB_MEAN, _block, _conv3x3, _layer_norm, attn_mask, relative_position_index

BLOCKS = 5  # Swin blocks an RDG, fixed in the published model
SHIFTED = (2, 4)  # the blocks shifted by half a window


def _widths(cfg: dict):
    """``(k, width)`` of an RDG's five blocks."""
    e, gc = cfg['embed_dim'], cfg['gc']
    for k in range(1, BLOCKS + 1):
        yield k, e + (k - 1) * gc


def _heads(heads: int, k: int, width: int) -> int:
    return heads if k == 1 else heads - width % heads


def state_dict_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], float, float]]:
    """``(key, shape, mean, std)`` of every weight of the checkpoint."""
    e, ws, cin, gc = cfg['embed_dim'], cfg['window_size'], cfg['in_chans'], cfg['gc']

    def conv(key, cout, cin_, k, std):
        return [(f'{key}.weight', (cout, cin_, k, k), 0.0, std), (f'{key}.bias', (cout,), 0.0, 0.01)]

    def lin(key, cout, cin_, std):
        return [(f'{key}.weight', (cout, cin_), 0.0, std), (f'{key}.bias', (cout,), 0.0, 0.02)]

    def norm(key, c):
        return [(f'{key}.weight', (c,), 1.0, 0.1), (f'{key}.bias', (c,), 0.0, 0.05)]

    spec = conv('conv_first', e, cin, 3, 1 / math.sqrt(9 * cin)) + norm('patch_embed.norm', e)
    for i, heads in enumerate(cfg['num_heads']):
        for k, width in _widths(cfg):
            b, hidden = f'layers.{i}.swin{k}', int(width * cfg['mlp_ratio'])
            spec += norm(f'{b}.norm1', width)
            spec += [(f'{b}.attn.relative_position_bias_table', ((2 * ws - 1) ** 2, _heads(heads, k, width)), 0.0, 0.5)]
            spec += lin(f'{b}.attn.qkv', 3 * width, width, 1 / math.sqrt(width))
            spec += lin(f'{b}.attn.proj', width, width, 0.5 / math.sqrt(width))
            spec += norm(f'{b}.norm2', width)
            spec += lin(f'{b}.mlp.fc1', hidden, width, 1 / math.sqrt(width))
            spec += lin(f'{b}.mlp.fc2', width, hidden, 0.5 / math.sqrt(hidden))
            spec += conv(f'layers.{i}.adjust{k}', gc if k < BLOCKS else e, width, 1, 1 / math.sqrt(width))
    spec += norm('norm', e) + conv('conv_after_body', e, e, 3, 1 / math.sqrt(9 * e))
    spec += conv('conv_before_upsample.0', NUM_FEAT, e, 3, 1 / math.sqrt(9 * e))
    for k in range(int(math.log2(cfg['upscale']))):
        spec += conv(f'upsample.{2 * k}', 4 * NUM_FEAT, NUM_FEAT, 3, 1 / math.sqrt(9 * NUM_FEAT))
    spec += conv('conv_last', cin, NUM_FEAT, 3, 0.25 / math.sqrt(9 * NUM_FEAT))
    return spec


def scale(cfg: dict) -> int:
    return cfg['upscale']


def fixed_buffers(cfg: dict) -> dict:
    """The checkpoint's buffers: relative-position indices and masks."""
    ws, size = cfg['window_size'], cfg['img_size']
    index = relative_position_index(ws)
    mask = attn_mask(size, size, ws, ws // 2)
    out = {}
    for i in range(len(cfg['num_heads'])):
        for k, _ in _widths(cfg):
            out[f'layers.{i}.swin{k}.attn.relative_position_index'] = index
            if k in SHIFTED:
                out[f'layers.{i}.swin{k}.attn_mask'] = mask
    return out


def _rdg(cfg, p, i, x, hw, heads, masks):
    """A residual dense group on (B, L, embed) tokens."""
    ws = cfg['window_size']
    feats = [x]
    for k, width in _widths(cfg):
        y = _block(cfg, p, f'layers.{i}.swin{k}', torch.cat(feats, -1), hw, _heads(heads, k, width),
                   ws // 2 if k in SHIFTED else 0, masks)
        y = TF.linear(y, p[f'layers.{i}.adjust{k}.weight'].flatten(1), p[f'layers.{i}.adjust{k}.bias'])
        feats.append(TF.leaky_relu(y, 0.2) if k < BLOCKS else y)
    return feats[-1] * 0.2 + x


def forward(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The forward of an NCHW batch in [0, 1]."""
    if cfg['upsampler'] != 'pixelshuffle' or cfg['resi_connection'] != '1conv':
        raise ValueError('this reference is the pixelshuffle, one-conv DRCT')
    ws, scale_ = cfg['window_size'], cfg['upscale']
    if cfg['img_size'] <= ws:
        raise ValueError('img_size at or below the window shrinks the windows, which this reference omits')
    h0, w0 = x.shape[2:]
    x = TF.pad(x, (0, -w0 % ws, 0, -h0 % ws), mode='reflect')
    h, w = x.shape[2:]
    mean = torch.tensor(RGB_MEAN, device=x.device).view(1, 3, 1, 1)
    x = (x - mean) * cfg['img_range']
    x = _conv3x3(x, p['conv_first.weight'], p['conv_first.bias'])

    masks = {(h, w): torch.from_numpy(attn_mask(h, w, ws, ws // 2)).to(x.device)}
    t = _layer_norm(p, 'patch_embed.norm', x.flatten(2).transpose(1, 2))
    for i, heads in enumerate(cfg['num_heads']):
        t = _rdg(cfg, p, i, t, (h, w), heads, masks)
    feat = _layer_norm(p, 'norm', t).transpose(1, 2).reshape(x.shape[0], -1, h, w)

    x = _conv3x3(feat, p['conv_after_body.weight'], p['conv_after_body.bias']) + x
    x = TF.leaky_relu(_conv3x3(x, p['conv_before_upsample.0.weight'], p['conv_before_upsample.0.bias']), 0.01)
    for k in range(int(math.log2(scale_))):
        x = TF.pixel_shuffle(_conv3x3(x, p[f'upsample.{2 * k}.weight'], p[f'upsample.{2 * k}.bias']), 2)
    x = _conv3x3(x, p['conv_last.weight'], p['conv_last.bias'])
    x = x / cfg['img_range'] + mean
    return x[:, :, : h0 * scale_, : w0 * scale_]
