"""Shared upsamplers.

Counterpart of ``resselt_tpu/nn/upsample.py``: DySample, the conv +
pixel-shuffle tail, the UniUpsample mode family (MoSR lineage) and
UniUpsampleV3 with the LDA_AQU attention upsampler (FDAT).  Module indices
follow the torch module lists; every mode is plain PyTorch, and a conv
that a family's ``prepare`` built (``ops.conv_route``) runs as it was built,
through ``PTree.conv``.
"""

from __future__ import annotations

import math

import torch

from . import functional as F
from .params import PTree


def dysample(p: PTree, x, scale: int, groups: int = 4, end_convolution: bool = True):
    """Content-adaptive upsampling (DySample) on NHWC ``x``.

    ``p`` scopes the DySample module keys: offset.{weight,bias},
    scope.weight, init_pos, [end_conv.{weight,bias}]."""
    n, h, w, c = x.shape
    s = scale
    g = groups

    offset = p.conv('offset', x)
    scope = F.conv2d(x, p['scope.weight'])
    init_pos = p['init_pos'].reshape(-1).to(x.dtype)  # (2*g*s*s,)
    offset = offset * F.sigmoid(scope) * 0.5 + init_pos

    # channel layout is [2, g, s, s] row-major (DySample._init_pos)
    off = offset.reshape(n, h, w, 2, g, s, s)

    # normalized sample coordinates; component 0 = x/W, 1 = y/H
    xs = (torch.arange(w, device=x.device, dtype=x.dtype) + 0.5).reshape(1, 1, w, 1, 1, 1)
    ys = (torch.arange(h, device=x.device, dtype=x.dtype) + 0.5).reshape(1, h, 1, 1, 1, 1)
    cx = 2 * (xs + off[:, :, :, 0]) / w - 1
    cy = 2 * (ys + off[:, :, :, 1]) / h - 1
    coords = torch.stack([cx, cy], dim=-1)  # (n, h, w, g, s, s, 2)

    # grid[b, gi, h*s+i, w*s+j] = coords[b, h, w, gi, i, j]
    grid = coords.permute(0, 3, 1, 4, 2, 5, 6).reshape(n * g, h * s, w * s, 2)

    xg = x.reshape(n, h, w, g, c // g).permute(0, 3, 1, 2, 4).reshape(n * g, h, w, c // g)
    out = F.grid_sample_bilinear(xg, grid, align_corners=False, padding_mode='border')
    out = out.reshape(n, g, h * s, w * s, c // g).permute(0, 2, 3, 1, 4).reshape(n, h * s, w * s, c)

    if end_convolution:
        out = p.conv('end_conv', out)
    return out


def conv_pixel_shuffle(p: PTree, x, conv_key: str, scale: int, padding='same'):
    """conv3x3 -> PixelShuffle tail."""
    return F.pixel_shuffle(p.conv(conv_key, x, padding=padding), scale)


SAMPLE_MODS = ('conv', 'pixelshuffledirect', 'pixelshuffle', 'nearest+conv', 'dysample')


def uni_upsample(p: PTree, x, mode: str, scale: int, out_dim: int, mid_dim: int, group: int = 4):
    """UniUpsample, the five modes of :data:`SAMPLE_MODS`.  ``p`` scopes the
    module's Sequential; its layer indices are the torch module list's."""
    in_dim = x.shape[-1]
    if scale == 1 or mode == 'conv':
        return p.conv('0', x, padding=1)
    if mode == 'pixelshuffledirect':
        return F.pixel_shuffle(p.conv('0', x, padding=1), scale)
    if mode == 'pixelshuffle':
        x = F.leaky_relu(p.conv('0', x, padding=1), 0.01)
        idx = 2
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                x = F.pixel_shuffle(p.conv(str(idx), x, padding=1), 2)
                idx += 2
        elif scale == 3:
            x = F.pixel_shuffle(p.conv(str(idx), x, padding=1), 3)
            idx += 2
        else:
            raise ValueError(f'scale {scale} unsupported for pixelshuffle')
        return p.conv(str(idx), x, padding=1)
    if mode == 'nearest+conv':
        if scale & (scale - 1) == 0:
            idx = 0
            for _ in range(int(math.log2(scale))):
                x = F.leaky_relu(F.interpolate_nearest(p.conv(str(idx), x, padding=1), scale_factor=2), 0.2)
                idx += 3
            x = F.leaky_relu(p.conv(str(idx), x, padding=1), 0.2)
            return p.conv(str(idx + 2), x, padding=1)
        if scale == 3:
            x = F.leaky_relu(F.interpolate_nearest(p.conv('0', x, padding=1), scale_factor=3), 0.2)
            x = F.leaky_relu(p.conv('3', x, padding=1), 0.2)
            return p.conv('5', x, padding=1)
        raise ValueError(f'scale {scale} unsupported for nearest+conv')
    if mode == 'dysample':
        if mid_dim != in_dim:
            x = F.leaky_relu(p.conv('0', x, padding=1), 0.01)
            return dysample(p.sub('2'), x, scale, groups=group)
        return dysample(p.sub('0'), x, scale, groups=group)
    raise ValueError(f'Unknown UniUpsample mode {mode}')


SAMPLE_MODS3 = SAMPLE_MODS + ('transpose+conv', 'lda', 'pa_up')


def _lda_base_offset(k_u: int, device='cpu', dtype=torch.float32) -> torch.Tensor:
    """LDA_AQU's ``base_offset`` buffer (not kept in checkpoints): the
    (dy, dx) of each of the k_u x k_u sample points, row-major, flat.
    Computed on ``device``: no host-to-device copy, which a CUDA graph
    capture would refuse."""
    pad = (k_u - 1) // 2
    base = torch.arange(-pad, pad + 1, device=device, dtype=dtype)
    return torch.stack([base.repeat_interleave(k_u), base.repeat(k_u)], dim=1).reshape(-1)


def lda_aqu(p: PTree, x, scale_factor: int, range_factor: float = 11.0):
    """LDA_AQU, the deformable-kernel attention upsampler, on NHWC ``x``.

    The hyperparameters come from the weights' shapes: hidden width, offset
    groups, k_u (sample points a side), k_e (the offset conv's kernel),
    heads (from the relative-position table, one without it).  Each output
    pixel's query (q upsampled bilinearly, corners aligned) attends over the
    k_u x k_u keys and values that ``grid_sample`` reads at its learned
    offsets (corners aligned, zeros outside)."""
    b, h, w, c = x.shape
    hidden = p.shape('proj_q.weight')[0]
    group_channel = p.shape('conv_offset.0.weight')[0]
    g = hidden // group_channel
    k_u = math.isqrt(p.shape('conv_offset.3.weight')[0] // 2)
    k_e = p.shape('conv_offset.3.weight')[-1]
    rpb = 'relative_position_bias_table' in p
    nh = p.shape('relative_position_bias_table')[1] if rpb else 1
    attn_dim = hidden // nh
    oh, ow = int(h * scale_factor), int(w * scale_factor)

    xn = F.layer_norm(x, p['layer_norm.weight'], p['layer_norm.bias'], eps=1e-6)
    q = F.conv2d(xn, p['proj_q.weight'])
    k = F.conv2d(xn, p['proj_k.weight'])
    q = F.interpolate_bilinear(q, size=(oh, ow), align_corners=True)

    def group_split(t):  # (b, H, W, ch) -> (b*g, H, W, ch/g)
        hh, ww, ch = t.shape[1:]
        return t.reshape(b, hh, ww, g, ch // g).permute(0, 3, 1, 2, 4).reshape(b * g, hh, ww, ch // g)

    off = p.conv('conv_offset.0', group_split(q), padding=1, groups=group_channel)
    off = F.layer_norm(off, p['conv_offset.1.weight'], p['conv_offset.1.bias'], eps=1e-6)
    off = p.conv('conv_offset.3', F.silu(off), padding=k_e // 2)
    base = _lda_base_offset(k_u, x.device, x.dtype)
    off = (torch.tanh(off) * range_factor + base).reshape(b * g, oh, ow, k_u, k_u, 2)

    # sample grid, normalised with aligned corners, xy order: (b*g, k_u*oh, k_u*ow, 2)
    ys = torch.arange(oh, device=x.device, dtype=x.dtype).reshape(1, oh, 1, 1, 1)
    xs = torch.arange(ow, device=x.device, dtype=x.dtype).reshape(1, 1, ow, 1, 1)
    ny = 2 * (off[..., 0] + ys) / (oh - 1) - 1
    nx = 2 * (off[..., 1] + xs) / (ow - 1) - 1
    grid = torch.stack([nx, ny], dim=-1).permute(0, 3, 1, 4, 2, 5).reshape(b * g, k_u * oh, k_u * ow, 2)

    def windows(t):  # (b*g, k_u*oh, k_u*ow, ch) -> (b, oh*ow, k_u*k_u, g*ch)
        ch = t.shape[-1]
        t = t.reshape(b, g, k_u, oh, k_u, ow, ch).permute(0, 3, 5, 2, 4, 1, 6)
        return t.reshape(b, oh * ow, k_u * k_u, g * ch)

    ks = F.grid_sample_bilinear(group_split(k), grid, align_corners=True, padding_mode='zeros')
    vs = F.grid_sample_bilinear(group_split(x), grid, align_corners=True, padding_mode='zeros')
    ks = windows(ks).reshape(b, oh * ow, k_u * k_u, nh, attn_dim).permute(0, 3, 1, 2, 4)
    vs = windows(vs).reshape(b, oh * ow, k_u * k_u, nh, c // nh).permute(0, 3, 1, 2, 4)
    if rpb:
        ks = ks + p['relative_position_bias_table'].reshape(1, nh, 1, k_u * k_u, attn_dim).to(x.dtype)

    qh = q.reshape(b, oh * ow, nh, attn_dim).permute(0, 2, 1, 3).unsqueeze(-2)  # (b, nh, oh*ow, 1, attn_dim)
    attn = F.softmax(torch.matmul(qh * attn_dim ** -0.5, ks.transpose(-1, -2)))
    out = torch.matmul(attn, vs)  # (b, nh, oh*ow, 1, c/nh)
    return out[..., 0, :].permute(0, 2, 1, 3).reshape(b, oh, ow, c)


def uni_upsample_v3_convs(params, key: str, mode: str, scale: int) -> tuple[dict, tuple]:
    """``ops.conv_route.prepare_convs``'s ``groups`` and ``skip`` for a
    UniUpsampleV3 under ``key``: LDA_AQU's depthwise offset conv, and a
    ``transpose+conv`` tail's transposed weights (only cast)."""
    groups = {k[: -len('.weight')]: v.shape[0] for k, v in params.items()
              if k.startswith(f'{key}.') and k.endswith('.conv_offset.0.weight')}
    skip = (f'{key}.0', f'{key}.2') if mode == 'transpose+conv' and scale != 1 else ()
    return groups, skip


def uni_upsample_v3(p: PTree, x, mode: str, scale: int, out_dim: int, mid_dim: int, group: int = 4,
                    dysample_end_kernel: int = 1):
    """UniUpsampleV3, the eight modes of :data:`SAMPLE_MODS3`.  At scale 1
    it is one 3x3 conv whatever ``mode`` says (the reference builds only
    that, so a 1x checkpoint holds ``0.weight`` / ``0.bias`` alone)."""
    in_dim = x.shape[-1]
    if scale == 1:
        return p.conv('0', x, padding=1)
    if mode in SAMPLE_MODS and mode != 'dysample':
        return uni_upsample(p, x, mode, scale, out_dim, mid_dim, group)
    if mode == 'dysample':
        if mid_dim != in_dim:
            x = F.leaky_relu(p.conv('0', x, padding=1), 0.01)
            dys = p.sub('2')
        else:
            dys = p.sub('0')
        out = dysample(dys, x, scale, groups=group, end_convolution=False)
        return dys.conv('end_conv', out, padding=dysample_end_kernel // 2)
    if mode == 'transpose+conv':
        if scale in (2, 3):
            stride, pad = (2, 1) if scale == 2 else (3, 0)
            x = F.conv_transpose2d(x, p['0.weight'], p.get('0.bias'), stride=stride, padding=pad)
            return p.conv('1', x, padding=1)
        if scale == 4:
            x = F.gelu(F.conv_transpose2d(x, p['0.weight'], p.get('0.bias'), stride=2, padding=1))
            x = F.conv_transpose2d(x, p['2.weight'], p.get('2.bias'), stride=2, padding=1)
            return p.conv('3', x, padding=1)
        raise ValueError(f'transpose+conv scale {scale} unsupported')
    if mode == 'lda':
        if mid_dim != in_dim:
            x = F.leaky_relu(p.conv('0', x, padding=1), 0.01)
            return p.conv('3', lda_aqu(p.sub('2'), x, scale), padding=1)
        return p.conv('1', lda_aqu(p.sub('0'), x, scale), padding=1)
    if mode == 'pa_up':
        if scale & (scale - 1) == 0:
            stages, factor = int(math.log2(scale)), 2
        elif scale == 3:
            stages, factor = 1, 3
        else:
            raise ValueError(f'pa_up scale {scale} unsupported')
        idx = 0
        for _ in range(stages):
            x = p.conv(str(idx + 1), F.interpolate_nearest(x, scale_factor=factor), padding=1)
            x = F.leaky_relu(x * F.sigmoid(p.conv(f'{idx + 2}.conv.0', x)), 0.2)
            x = F.leaky_relu(p.conv(str(idx + 4), x, padding=1), 0.2)
            idx += 6
        return p.conv(str(idx), x, padding=1)
    raise ValueError(f'Unknown UniUpsampleV3 mode {mode}')
