"""SwinIR (classical SR, pixelshuffle tail, one-conv residual connection),
written from the published ``models/network_swinir.py``, in plain float32
PyTorch on NCHW images and (B, L, C) tokens.

The state dict uses the published key names, buffers included: every
block's ``attn.relative_position_index`` and every shifted block's
``attn_mask`` (built for ``img_size``, as the published constructor
registers it; the forward computes the mask for the size it is given, as
the published ``calculate_mask`` does).  The random weights are scaled so
that the attention is far from uniform and every bias and norm parameter
differs from its neutral value.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF


RGB_MEAN = (0.4488, 0.4371, 0.4040)
NUM_FEAT = 64  # the pixelshuffle tail's width, fixed in the published model


def _blocks(cfg: dict):
    for i, depth in enumerate(cfg['depths']):
        for j in range(depth):
            yield i, j, f'layers.{i}.residual_group.blocks.{j}'


def state_dict_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], float, float]]:
    """``(key, shape, mean, std)`` of every weight of the checkpoint."""
    e, ws, cin = cfg['embed_dim'], cfg['window_size'], cfg['in_chans']
    hidden = int(e * cfg['mlp_ratio'])

    def conv(key, cout, cin_, std):
        return [(f'{key}.weight', (cout, cin_, 3, 3), 0.0, std), (f'{key}.bias', (cout,), 0.0, 0.01)]

    def lin(key, cout, cin_, std):
        return [(f'{key}.weight', (cout, cin_), 0.0, std), (f'{key}.bias', (cout,), 0.0, 0.02)]

    def norm(key):
        return [(f'{key}.weight', (e,), 1.0, 0.1), (f'{key}.bias', (e,), 0.0, 0.05)]

    spec = conv('conv_first', e, cin, 1 / math.sqrt(9 * cin)) + norm('patch_embed.norm')
    for i, j, b in _blocks(cfg):
        heads = cfg['num_heads'][i]
        spec += norm(f'{b}.norm1')
        spec += [(f'{b}.attn.relative_position_bias_table', ((2 * ws - 1) ** 2, heads), 0.0, 0.5)]
        spec += lin(f'{b}.attn.qkv', 3 * e, e, 1 / math.sqrt(e)) + lin(f'{b}.attn.proj', e, e, 0.5 / math.sqrt(e))
        spec += norm(f'{b}.norm2')
        spec += lin(f'{b}.mlp.fc1', hidden, e, 1 / math.sqrt(e)) + lin(f'{b}.mlp.fc2', e, hidden, 0.5 / math.sqrt(hidden))
        if j == cfg['depths'][i] - 1:
            spec += conv(f'layers.{i}.conv', e, e, 0.5 / math.sqrt(9 * e))
    spec += norm('norm') + conv('conv_after_body', e, e, 1 / math.sqrt(9 * e))
    spec += conv('conv_before_upsample.0', NUM_FEAT, e, 1 / math.sqrt(9 * e))
    for k in range(int(math.log2(cfg['upscale']))):
        spec += conv(f'upsample.{2 * k}', 4 * NUM_FEAT, NUM_FEAT, 1 / math.sqrt(9 * NUM_FEAT))
    spec += conv('conv_last', cfg['in_chans'], NUM_FEAT, 0.25 / math.sqrt(9 * NUM_FEAT))
    return spec


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing='ij')).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The published ``calculate_mask``: (nW, ws*ws, ws*ws), 0 or -100."""
    img = np.zeros((h, w), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    m = mw[:, None, :] - mw[:, :, None]
    return np.where(m != 0, -100.0, 0.0).astype(np.float32)


def scale(cfg: dict) -> int:
    return cfg['upscale']


def fixed_buffers(cfg: dict) -> dict:
    """The checkpoint's buffers: relative-position indices and masks."""
    ws, size = cfg['window_size'], cfg['img_size']
    index = relative_position_index(ws)
    mask = attn_mask(size, size, ws, ws // 2)
    out = {}
    for _, j, b in _blocks(cfg):
        out[f'{b}.attn.relative_position_index'] = index
        if j % 2 == 1:
            out[f'{b}.attn_mask'] = mask
    return out


def _conv3x3(x, w, b):
    """A same-padded 3x3 conv as one matrix product over the unfolded
    input, so that the float32 product runs on cuBLAS: cuDNN's float32
    convolution without TF32 took 293 ms for one 180 -> 180 conv of four
    176 x 176 windows on an H100, this 2.4 ms."""
    n, _, h, wd = x.shape
    cols = TF.unfold(x, 3, padding=1)  # (n, c * 9, h * w), c-major as w.view(o, c * 9)
    return (w.reshape(w.shape[0], -1) @ cols).view(n, -1, h, wd) + b[None, :, None, None]


def _layer_norm(p, key, x):
    return TF.layer_norm(x, (x.shape[-1],), p[f'{key}.weight'], p[f'{key}.bias'], 1e-5)


def _partition(x, ws):
    b, h, w, c = x.shape
    return x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _reverse(windows, ws, h, w):
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _window_attention(p, b, x, heads, mask):
    bw, n, c = x.shape
    qkv = TF.linear(x, p[f'{b}.attn.qkv.weight'], p[f'{b}.attn.qkv.bias'])
    q, k, v = qkv.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
    table, index = p[f'{b}.attn.relative_position_bias_table'], p[f'{b}.attn.relative_position_index']
    attn = attn + table[index.view(-1)].view(n, n, -1).permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(bw // nw, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(bw, n, c)
    return TF.linear(out, p[f'{b}.attn.proj.weight'], p[f'{b}.attn.proj.bias'])


def _block(cfg, p, b, x, hw, heads, shift, masks):
    h, w = hw
    ws = cfg['window_size']
    bsz, _, c = x.shape
    y = _layer_norm(p, f'{b}.norm1', x).view(bsz, h, w, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    y = _window_attention(p, b, _partition(y, ws), heads, masks.get((h, w)) if shift else None)
    y = _reverse(y, ws, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y.reshape(bsz, h * w, c)
    z = TF.linear(_layer_norm(p, f'{b}.norm2', x), p[f'{b}.mlp.fc1.weight'], p[f'{b}.mlp.fc1.bias'])
    return x + TF.linear(TF.gelu(z), p[f'{b}.mlp.fc2.weight'], p[f'{b}.mlp.fc2.bias'])


def forward(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The forward of an NCHW batch in [0, 1]."""
    if cfg['upsampler'] != 'pixelshuffle' or cfg['resi_connection'] != '1conv':
        raise ValueError('this reference is the pixelshuffle, one-conv SwinIR')
    ws, scale = cfg['window_size'], cfg['upscale']
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
    for i, depth in enumerate(cfg['depths']):
        y = t
        for j in range(depth):
            y = _block(cfg, p, f'layers.{i}.residual_group.blocks.{j}', y, (h, w), cfg['num_heads'][i],
                       0 if j % 2 == 0 else ws // 2, masks)
        y = y.transpose(1, 2).reshape(x.shape[0], -1, h, w)
        y = _conv3x3(y, p[f'layers.{i}.conv.weight'], p[f'layers.{i}.conv.bias'])
        t = y.flatten(2).transpose(1, 2) + t
    feat = _layer_norm(p, 'norm', t).transpose(1, 2).reshape(x.shape[0], -1, h, w)

    x = _conv3x3(feat, p['conv_after_body.weight'], p['conv_after_body.bias']) + x
    x = TF.leaky_relu(_conv3x3(x, p['conv_before_upsample.0.weight'], p['conv_before_upsample.0.bias']), 0.01)
    for k in range(int(math.log2(scale))):
        x = TF.pixel_shuffle(_conv3x3(x, p[f'upsample.{2 * k}.weight'], p[f'upsample.{2 * k}.bias']), 2)
    x = _conv3x3(x, p['conv_last.weight'], p['conv_last.bias'])
    x = x / cfg['img_range'] + mean
    return x[:, :, : h0 * scale, : w0 * scale]
