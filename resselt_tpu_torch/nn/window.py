"""Shifted-window attention primitives (SwinIR lineage).

Counterpart of ``resselt_tpu/nn/window.py``: the same window partition,
relative-position index and shift mask (numpy geometry, copied), and the
same attention, and DAT's rectangular-window shift mask.
:func:`multi_head_attention` sends every window attention with a bias
that :func:`window_mha_supported` takes to ``ops.window_mha`` (on the
card: ``csrc/window_attn.cu``); the rest (no bias, HAT's M > N overlapping
keys, or a head_dim above the kernel's) takes a plain path with the JAX
package's ``_mha_xla`` semantics.  The plain path's calls on a CUDA tensor
are counted in ``multi_head_attention.plain_calls``, and per shape in the
``multi_head_attention.plain_by_shape`` Counter under ``(windows, n, m, c,
heads, masked)``: the attentions the kernel does not take are visible, not
silent.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..ops import window_mha, window_mha_supported


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B*nW, ws*ws, C), row-major window order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Swin relative position index table, (wh*ww, wh*ww) int."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def swin_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray | None:
    """SW-MSA additive mask, (nW, ws*ws, ws*ws) f32 with 0 / -100 entries."""
    if shift == 0:
        return None
    img_mask = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    # torch builds the mask as (m.unsqueeze(1) - m.unsqueeze(2)): diff[w, i, j] = m[w, j] - m[w, i]
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def rect_attn_mask(h: int, w: int, sp_h: int, sp_w: int, shift_h: int, shift_w: int) -> np.ndarray:
    """Additive shift mask for (sp_h, sp_w) windows of an (h, w) map rolled
    by (-shift_h, -shift_w) (DAT-style), (nW, sp_h*sp_w, sp_h*sp_w) f32 with
    0 / -100 entries."""
    img_mask = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -sp_h), slice(-sp_h, -shift_h), slice(-shift_h, None)):
        for wsl in (slice(0, -sp_w), slice(-sp_w, -shift_w), slice(-shift_w, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(h // sp_h, sp_h, w // sp_w, sp_w).transpose(0, 2, 1, 3).reshape(-1, sp_h * sp_w)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _cached(cache: dict, key: tuple, build, device) -> torch.Tensor:
    mask = cache.get(key)
    if mask is None:
        mask = cache[key] = torch.from_numpy(build()).to(device)
    return mask


def shift_mask(cache: dict, h: int, w: int, ws: int, shift: int, device) -> torch.Tensor | None:
    """:func:`swin_attn_mask` as an f32 tensor on ``device``, built once
    per ``(h, w, ws, shift, device)`` and kept in ``cache``."""
    if shift == 0:
        return None
    return _cached(cache, (h, w, ws, shift, str(device)), lambda: swin_attn_mask(h, w, ws, shift), device)


def rect_shift_mask(cache: dict, h: int, w: int, sp_h: int, sp_w: int, sh_h: int, sh_w: int, device) -> torch.Tensor:
    """:func:`rect_attn_mask` as an f32 tensor on ``device``, built once per
    geometry and device and kept in ``cache``."""
    return _cached(cache, ('rect', h, w, sp_h, sp_w, sh_h, sh_w, str(device)),
                   lambda: rect_attn_mask(h, w, sp_h, sp_w, sh_h, sh_w), device)


def relative_position_bias(table, rpi, dtype: torch.dtype) -> torch.Tensor:
    """The (heads, N, M) bias that ``table`` (entries, heads) gives through
    index ``rpi`` (N, M) (M = N for a square window, M > N for HAT's
    overlapping keys), rounded to ``dtype`` (as the JAX package casts it to
    the activations' dtype) and held in f32, contiguous."""
    n, m = rpi.shape
    bias = table[rpi.reshape(-1)].reshape(n, m, table.shape[1]).permute(2, 0, 1)
    return bias.to(dtype).float().contiguous()


def multi_head_attention(q, k, v, num_heads: int, scale: float, bias=None, mask=None):
    """Batched MHA over token sequences.

    q: (B, N, C) already projected; k/v: (B, M, C) (M == N for plain window
    attention; M > N for HAT's overlapping cross-attention); bias:
    (num_heads, N, M) additive; mask: (nW, N, M) additive where B is a
    multiple of nW."""
    b, n, c = q.shape
    if bias is not None and k.shape[1] == n and window_mha_supported(n, c, num_heads):
        return window_mha(q, k, v, bias, mask, num_heads=num_heads, scale=float(scale))
    if q.is_cuda:
        multi_head_attention.plain_calls += 1
        multi_head_attention.plain_by_shape[(b, n, k.shape[1], c, num_heads, mask is not None)] += 1
    return _mha_plain(q, k, v, num_heads, scale, bias, mask)


multi_head_attention.plain_calls = 0
multi_head_attention.plain_by_shape = Counter()


def _mha_plain(q, k, v, num_heads: int, scale: float, bias, mask):
    """The JAX package's ``_mha_xla``: scores in q's dtype, then bias, mask
    and softmax."""
    b, n, c = q.shape
    m = k.shape[1]
    hd = c // num_heads
    q = q.reshape(b, n, num_heads, hd).transpose(1, 2)
    k = k.reshape(b, m, num_heads, hd).transpose(1, 2)
    v = v.reshape(b, m, num_heads, hd).transpose(1, 2)
    attn = torch.matmul(q * scale, k.transpose(-1, -2))
    if bias is not None:
        attn = attn + bias.to(attn.dtype)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b // nw, nw, num_heads, n, m) + mask.to(attn.dtype)[None, :, None]
        attn = attn.reshape(b, num_heads, n, m)
    out = torch.matmul(torch.softmax(attn, dim=-1), v)
    return out.transpose(1, 2).reshape(b, n, c)


def swin_window_attention(p, x_windows, num_heads: int, mask=None, qk_scale=None):
    """WindowAttention with relative position bias.

    ``p``: PTree scoped to the attention module: qkv/proj and the
    ``relative_position_bias`` that the loader's ``prepare`` built with
    :func:`relative_position_bias`; ``x_windows``: (B*nW, N, C).  q, k and
    v are the channel slices of one qkv projection, handed over in place."""
    c = x_windows.shape[2]
    scale = qk_scale if qk_scale is not None else (c // num_heads) ** -0.5
    qkv = p.linear('qkv', x_windows)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    out = multi_head_attention(q, k, v, num_heads, scale, bias=p['relative_position_bias'], mask=mask)
    return p.linear('proj', out)
