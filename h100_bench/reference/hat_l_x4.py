"""HAT (classical SR, pixelshuffle tail, one-conv group residual), written
from the published ``hat/archs/hat_arch.py``, in plain float32 PyTorch on
NCHW images and (B, L, C) tokens.

A residual hybrid attention group (RHAG) is ``depth`` hybrid attention
blocks (HAB) and one overlapping cross-attention block (OCAB), then a 3x3
conv on the group's output plus the group's input.  A HAB is a Swin block
(the second, fourth and sixth shifted by half a window) whose attention
branch gains a channel-attention conv branch (CAB: 3x3 conv to embed /
compress_ratio channels, GELU, 3x3 conv back, then x sigmoid(conv(relu(
conv(mean over the image))))) scaled by ``conv_scale``.  An OCAB takes q
from a window's ``window_size``^2 tokens and k, v from the ``owin``^2 tokens
of the overlapping window around it (``nn.Unfold(owin, stride=window_size,
padding=(owin - window_size) / 2)``, owin = window_size + overlap_ratio x
window_size), with a relative-position bias of its own index, then a
projection, the residual and an MLP.  The window partition, the shift mask,
the self-attention index, the layer norm and the unfolded 3x3 conv come
from ``swinir_m_x4``.

Departures from the published code, none of which changes a value:
- tokens stay (B, L, C) between blocks, where the published RHAG unembeds
  them to an image around its conv (``PatchUnEmbed`` / ``PatchEmbed``
  without a norm) and a HAB reshapes them for its CAB;
- the input is reflect-padded to a multiple of the window and the output
  cropped back, as the published test-time model pads an image;
- the two index buffers are read from the checkpoint, as the published
  model registers and uses them.

The state dict uses the published key names, the two index buffers
included.  The random weights are scaled as ``swinir_m_x4``'s, by each
layer's fan-in, so that the attention is far from uniform.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from .swinir_m_x4 import NUM_FEAT, RGB_MEAN, _conv3x3, _layer_norm, _partition, _reverse, attn_mask, relative_position_index


def overlap_window(cfg: dict) -> int:
    ws = cfg['window_size']
    return int(ws * cfg['overlap_ratio']) + ws


def relative_position_index_oca(ws: int, owin: int) -> np.ndarray:
    """The published ``calculate_rpi_oca``: (ws^2, owin^2).  Its shift,
    ws - owin + 1, leaves negative entries, which indexing wraps to the end
    of the table, as in the published model."""
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing='ij')).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(owin), np.arange(owin), indexing='ij')).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - owin + 1
    rel[:, :, 1] += ws - owin + 1
    rel[:, :, 0] *= ws + owin - 1
    return rel.sum(-1)


def state_dict_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], float, float]]:
    """``(key, shape, mean, std)`` of every weight of the checkpoint."""
    e, ws, cin = cfg['embed_dim'], cfg['window_size'], cfg['in_chans']
    owin, hidden = overlap_window(cfg), int(e * cfg['mlp_ratio'])
    squeezed, compressed = e // cfg['squeeze_factor'], e // cfg['compress_ratio']

    def conv(key, cout, cin_, k, std):
        return [(f'{key}.weight', (cout, cin_, k, k), 0.0, std), (f'{key}.bias', (cout,), 0.0, 0.01)]

    def lin(key, cout, cin_, std):
        return [(f'{key}.weight', (cout, cin_), 0.0, std), (f'{key}.bias', (cout,), 0.0, 0.02)]

    def norm(key):
        return [(f'{key}.weight', (e,), 1.0, 0.1), (f'{key}.bias', (e,), 0.0, 0.05)]

    def mlp(key):
        return lin(f'{key}.mlp.fc1', hidden, e, 1 / math.sqrt(e)) + lin(f'{key}.mlp.fc2', e, hidden,
                                                                        0.5 / math.sqrt(hidden))

    spec = conv('conv_first', e, cin, 3, 1 / math.sqrt(9 * cin)) + norm('patch_embed.norm')
    for i, (depth, heads) in enumerate(zip(cfg['depths'], cfg['num_heads'])):
        g = f'layers.{i}.residual_group'
        for j in range(depth):
            b = f'{g}.blocks.{j}'
            spec += norm(f'{b}.norm1')
            spec += conv(f'{b}.conv_block.cab.0', compressed, e, 3, 1 / math.sqrt(9 * e))
            spec += conv(f'{b}.conv_block.cab.2', e, compressed, 3, 1 / math.sqrt(9 * compressed))
            spec += conv(f'{b}.conv_block.cab.3.attention.1', squeezed, e, 1, 1 / math.sqrt(e))
            spec += conv(f'{b}.conv_block.cab.3.attention.3', e, squeezed, 1, 1 / math.sqrt(squeezed))
            spec += [(f'{b}.attn.relative_position_bias_table', ((2 * ws - 1) ** 2, heads), 0.0, 0.5)]
            spec += lin(f'{b}.attn.qkv', 3 * e, e, 1 / math.sqrt(e)) + lin(f'{b}.attn.proj', e, e, 0.5 / math.sqrt(e))
            spec += norm(f'{b}.norm2') + mlp(b)
        o = f'{g}.overlap_attn'
        spec += norm(f'{o}.norm1') + lin(f'{o}.qkv', 3 * e, e, 1 / math.sqrt(e))
        spec += [(f'{o}.relative_position_bias_table', ((ws + owin - 1) ** 2, heads), 0.0, 0.5)]
        spec += lin(f'{o}.proj', e, e, 0.5 / math.sqrt(e)) + norm(f'{o}.norm2') + mlp(o)
        spec += conv(f'layers.{i}.conv', e, e, 3, 0.5 / math.sqrt(9 * e))
    spec += norm('norm') + conv('conv_after_body', e, e, 3, 1 / math.sqrt(9 * e))
    spec += conv('conv_before_upsample.0', NUM_FEAT, e, 3, 1 / math.sqrt(9 * e))
    for k in range(int(math.log2(cfg['upscale']))):
        spec += conv(f'upsample.{2 * k}', 4 * NUM_FEAT, NUM_FEAT, 3, 1 / math.sqrt(9 * NUM_FEAT))
    spec += conv('conv_last', cin, NUM_FEAT, 3, 0.25 / math.sqrt(9 * NUM_FEAT))
    return spec


def scale(cfg: dict) -> int:
    return cfg['upscale']


def fixed_buffers(cfg: dict) -> dict:
    """The checkpoint's buffers: the two relative-position indices."""
    ws = cfg['window_size']
    return {'relative_position_index_SA': relative_position_index(ws),
            'relative_position_index_OCA': relative_position_index_oca(ws, overlap_window(cfg))}


def _bias(p, key, index, n, m):
    """(heads, n, m) from the table under ``key`` through ``index``."""
    return p[f'{key}.relative_position_bias_table'][index.reshape(-1)].view(n, m, -1).permute(2, 0, 1)


def _attention(q, k, v, heads, bias, mask):
    """softmax(q k^T / sqrt(d) + bias + mask) v on (B, N, C) q and (B, M, C) k, v."""
    bw, n, c = q.shape
    m = k.shape[1]
    d = c // heads
    q = q.reshape(bw, n, heads, d).transpose(1, 2) * d ** -0.5
    k = k.reshape(bw, m, heads, d).transpose(1, 2)
    v = v.reshape(bw, m, heads, d).transpose(1, 2)
    attn = q @ k.transpose(-2, -1) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(bw // nw, nw, heads, n, m) + mask[None, :, None]).view(-1, heads, n, m)
    return (attn.softmax(-1) @ v).transpose(1, 2).reshape(bw, n, c)


def _mlp(p, key, x):
    z = TF.linear(_layer_norm(p, f'{key}.norm2', x), p[f'{key}.mlp.fc1.weight'], p[f'{key}.mlp.fc1.bias'])
    return x + TF.linear(TF.gelu(z), p[f'{key}.mlp.fc2.weight'], p[f'{key}.mlp.fc2.bias'])


def _cab(p, key, img):
    """The channel-attention conv branch on an NCHW image."""
    y = TF.gelu(_conv3x3(img, p[f'{key}.cab.0.weight'], p[f'{key}.cab.0.bias']))
    y = _conv3x3(y, p[f'{key}.cab.2.weight'], p[f'{key}.cab.2.bias'])
    a = y.mean(dim=(2, 3))
    a = TF.relu(TF.linear(a, p[f'{key}.cab.3.attention.1.weight'].flatten(1), p[f'{key}.cab.3.attention.1.bias']))
    a = torch.sigmoid(TF.linear(a, p[f'{key}.cab.3.attention.3.weight'].flatten(1), p[f'{key}.cab.3.attention.3.bias']))
    return y * a[:, :, None, None]


def _hab(cfg, p, b, x, hw, heads, shift, mask):
    h, w = hw
    ws = cfg['window_size']
    bsz, _, c = x.shape
    y = _layer_norm(p, f'{b}.norm1', x)
    conv_x = _cab(p, f'{b}.conv_block', y.transpose(1, 2).reshape(bsz, c, h, w)).flatten(2).transpose(1, 2)
    y = y.view(bsz, h, w, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    win = _partition(y, ws)
    qkv = TF.linear(win, p[f'{b}.attn.qkv.weight'], p[f'{b}.attn.qkv.bias'])
    bias = _bias(p, f'{b}.attn', p['relative_position_index_SA'], ws * ws, ws * ws)
    y = _attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], heads, bias, mask if shift else None)
    y = _reverse(TF.linear(y, p[f'{b}.attn.proj.weight'], p[f'{b}.attn.proj.bias']), ws, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y.reshape(bsz, h * w, c) + conv_x * cfg['conv_scale']
    return _mlp(p, b, x)


def _ocab(cfg, p, o, x, hw, heads):
    h, w = hw
    ws, owin = cfg['window_size'], overlap_window(cfg)
    bsz, _, c = x.shape
    y = _layer_norm(p, f'{o}.norm1', x)
    qkv = TF.linear(y, p[f'{o}.qkv.weight'], p[f'{o}.qkv.bias']).view(bsz, h, w, 3, c)
    q = _partition(qkv[:, :, :, 0], ws)
    kv = qkv[:, :, :, 1:].reshape(bsz, h, w, 2 * c).permute(0, 3, 1, 2)  # (b, 2c, h, w): k's channels, then v's
    kv = TF.unfold(kv, owin, stride=ws, padding=(owin - ws) // 2)  # (b, 2c * owin^2, windows)
    kv = kv.view(bsz, 2, c, owin * owin, -1).permute(1, 0, 4, 3, 2).reshape(2, -1, owin * owin, c)
    bias = _bias(p, o, p['relative_position_index_OCA'], ws * ws, owin * owin)
    y = _reverse(_attention(q, kv[0], kv[1], heads, bias, None), ws, h, w).reshape(bsz, h * w, c)
    x = TF.linear(y, p[f'{o}.proj.weight'], p[f'{o}.proj.bias']) + x
    return _mlp(p, o, x)


def forward(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The forward of an NCHW batch in [0, 1]."""
    if cfg['upsampler'] != 'pixelshuffle' or cfg['resi_connection'] != '1conv':
        raise ValueError('this reference is the pixelshuffle, one-conv HAT')
    ws, scale_ = cfg['window_size'], cfg['upscale']
    if cfg['img_size'] <= ws:
        raise ValueError('img_size at or below the window shrinks the windows, which this reference omits')
    h0, w0 = x.shape[2:]
    x = TF.pad(x, (0, -w0 % ws, 0, -h0 % ws), mode='reflect')
    h, w = x.shape[2:]
    mean = torch.tensor(RGB_MEAN, device=x.device).view(1, 3, 1, 1)
    x = (x - mean) * cfg['img_range']
    x = _conv3x3(x, p['conv_first.weight'], p['conv_first.bias'])

    mask = torch.from_numpy(attn_mask(h, w, ws, ws // 2)).to(x.device)
    t = _layer_norm(p, 'patch_embed.norm', x.flatten(2).transpose(1, 2))
    for i, (depth, heads) in enumerate(zip(cfg['depths'], cfg['num_heads'])):
        g = f'layers.{i}.residual_group'
        y = t
        for j in range(depth):
            y = _hab(cfg, p, f'{g}.blocks.{j}', y, (h, w), heads, 0 if j % 2 == 0 else ws // 2, mask)
        y = _ocab(cfg, p, f'{g}.overlap_attn', y, (h, w), heads)
        y = _conv3x3(y.transpose(1, 2).reshape(x.shape[0], -1, h, w), p[f'layers.{i}.conv.weight'],
                     p[f'layers.{i}.conv.bias'])
        t = y.flatten(2).transpose(1, 2) + t
    feat = _layer_norm(p, 'norm', t).transpose(1, 2).reshape(x.shape[0], -1, h, w)

    x = _conv3x3(feat, p['conv_after_body.weight'], p['conv_after_body.bias']) + x
    x = TF.leaky_relu(_conv3x3(x, p['conv_before_upsample.0.weight'], p['conv_before_upsample.0.bias']), 0.01)
    for k in range(int(math.log2(scale_))):
        x = TF.pixel_shuffle(_conv3x3(x, p[f'upsample.{2 * k}.weight'], p[f'upsample.{2 * k}.bias']), 2)
    x = _conv3x3(x, p['conv_last.weight'], p['conv_last.bias'])
    x = x / cfg['img_range'] + mean
    return x[:, :, : h0 * scale_, : w0 * scale_]
