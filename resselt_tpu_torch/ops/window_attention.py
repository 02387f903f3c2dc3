"""Window multi-head attention with an additive bias and shift mask.

Counterpart of ``resselt_tpu/ops/window_attention.py``'s
``window_mha_pallas``.  For every window and head it computes

    O = softmax(scale * Q K^T + bias[h] + mask[w mod nW]) V

with the scores, bias, mask and softmax in f32 and the output in the
input's dtype.  On a CUDA tensor :func:`window_mha` launches the
hand-written Hopper kernel ``csrc/window_attn.cu`` (f32: exact FMA; bf16 and
fp16: tensor cores with f32 accumulation, persistent blocks that keep their
bias rows in shared memory and skip all-zero mask windows; windows of more
than 64 tokens on wgmma with one exact softmax pass a window) or raises; on
a CPU tensor it computes the plain version :func:`window_mha_ref`.  The
wrapper counts its kernel launches in ``window_mha.launches``, per shape in
the ``window_mha.by_shape`` Counter under ``(windows, n, c, heads,
masked)``, and per route in the ``window_mha.by_kernel`` Counter under
``(kernel, windows, n, c, heads, masked, head_pad)``: ``kernel`` the
``__global__`` function that ran (one of :data:`ROUTE_KERNELS`), as the
CUDA source's own ``resselt_window_attn_route`` decides for the dispatch,
and ``head_pad`` the head width launched (above head_dim where the wrapper
padded the heads).

q, k and v may be the three channel slices ``qkv[..., :C]``,
``qkv[..., C:2C]``, ``qkv[..., 2C:]`` of one ``(B, N, 3C)`` projection:
the kernel reads them in place through their token pitch.  In bf16 and
fp16 a head whose rows are only 2-byte aligned (an odd head_dim, as DRCT's
53) is first copied into heads zero-padded to a multiple of 8 elements:
the kernel stages such rows with 2-byte loads, which took 30.3 ms at
DRCT's bench shape against 9.2 ms for head_dim 46 on an H100.  The padding
changes no score and no output column, which is why the JAX keyword
``head_pad=`` is checked as JAX checks it and otherwise changes nothing.

:func:`window_mha` carries a gradient (:class:`_WindowMHA`, on both
devices), computed in plain torch in f32 from P recomputed as in the
forward: ``dV = P^T dO``, ``dS = P * (dO V^T - rowsum(dO V^T * P))``,
``dq = scale dS k``, ``dk = scale dS^T q`` and the bias's ``dS`` summed
over the windows; the mask gets none.  It runs inside the span
:data:`BACKWARD_RANGE` (``tracing``), on runs of windows whose score tensors hold at most
:data:`BACKWARD_CHUNK_BYTES` each.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from collections import Counter

import torch
import torch.nn.functional as TF

from .. import tracing
from . import _build

BACKWARD_RANGE = 'window_mha.backward'
# the __global__ function of csrc/window_attn.cu that a launch runs, by dtype kind and
# resselt_window_attn_route's answer: 0 the first pair, 1 the "any" kernels, 2 the wgmma kernel
ROUTE_KERNELS = {('f32', 0): 'wattn_f32_kernel', ('f32', 1): 'wattn_f32_any_kernel',
                 ('h16', 0): 'wattn_h16_kernel', ('h16', 1): 'wattn_h16_any_kernel',
                 ('h16', 2): 'wattn_wgmma_kernel'}
BACKWARD_CHUNK_BYTES = 1 << 28  # f32 (windows, heads, n, n) bytes of one run of the backward


def window_mha_supported(n: int, c: int, num_heads: int) -> bool:
    """Shapes :func:`window_mha` (and its kernel) take: the JAX kernel's,
    every n >= 1 tokens per window and C a multiple of heads >= 1."""
    return n >= 1 and num_heads >= 1 and c % num_heads == 0


def window_mha_ref(q, k, v, bias, mask=None, *, num_heads: int, scale: float) -> torch.Tensor:
    """Plain version, with the JAX kernel's semantics: q, k, v taken to f32,
    q scaled in f32, scores + bias + mask and the softmax in f32, P V in
    f32, cast back to q's dtype.  In f32 this is the JAX package's
    ``_mha_xla``; in bf16 it does not round the scores to bf16 first, as
    ``_mha_xla`` does (the kernel differs from it only by a full-f32
    softmax)."""
    b, n, c = q.shape
    hd = c // num_heads

    def heads(t):
        return t.float().reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)

    s = torch.matmul(heads(q) * scale, heads(k).transpose(-1, -2)) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(b // nw, nw, num_heads, n, n) + mask.float()[None, :, None]).reshape(b, num_heads, n, n)
    o = torch.matmul(torch.softmax(s, dim=-1), heads(v))
    return o.transpose(1, 2).reshape(b, n, c).to(q.dtype)


_mask_flags: dict[int, tuple] = {}  # id(mask) -> (weak reference to the mask, its version, flags)


def mask_window_flags(mask: torch.Tensor) -> torch.Tensor:
    """One uint8 per window of an additive ``(nW, N, N)`` mask: 1 where the
    window's tile holds a non-zero value, 0 where it is all zero (adding
    0.0 is exact, so the kernel skips such a tile).  Computed once per mask
    tensor and kept while the tensor lives; a mask written in place since
    is scanned again."""
    key = id(mask)
    cached = _mask_flags.get(key)
    if cached is not None and cached[0]() is mask and cached[1] == mask._version:
        return cached[2]
    flags = (mask != 0).flatten(1).any(1).to(torch.uint8).contiguous()
    _mask_flags[key] = (weakref.ref(mask, lambda _, key=key: _mask_flags.pop(key, None)), mask._version, flags)
    return flags


def _lib() -> ctypes.CDLL:
    lib = _build.load('window_attn')
    if not getattr(lib, '_resselt_typed', False):
        tail = [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.resselt_window_attn_f32.argtypes = [ctypes.c_void_p] * 6 + tail
        for fn in (lib.resselt_window_attn_bf16, lib.resselt_window_attn_f16):
            fn.argtypes = [ctypes.c_void_p] * 7 + tail  # + the mask-window flags
        for fn in (lib.resselt_window_attn_f32, lib.resselt_window_attn_bf16, lib.resselt_window_attn_f16):
            fn.restype = ctypes.c_int
        lib.resselt_window_attn_max_windows.argtypes = [ctypes.c_int] * 4
        lib.resselt_window_attn_max_windows.restype = ctypes.c_longlong
        lib.resselt_window_attn_route.argtypes = [ctypes.c_int] * 3
        lib.resselt_window_attn_route.restype = ctypes.c_int
        lib._resselt_typed = True
    return lib


def _token_strides(q, k, v) -> tuple[int, int]:
    """(window stride, token stride) in elements, shared by q, k and v,
    whose channels must lie next to each other (contiguous tensors, or
    channel slices of one wider tensor)."""
    strides = {t.stride() for t in (q, k, v)}
    if len(strides) != 1:
        raise ValueError(f'window attention kernel needs q, k, v at the same strides, got {sorted(strides)}')
    sw, st, sc = strides.pop()
    if sc != 1 or st < q.shape[2] or sw < q.shape[1] * st:
        raise ValueError(f'window attention kernel needs tokens at one pitch with channels next to each other, '
                         f'got shape {tuple(q.shape)} strides {(sw, st, sc)}')
    return sw, st


def _launch(q, k, v, bias, mask, num_heads: int, scale: float) -> torch.Tensor:
    """Check the operands, launch the kernel on the current stream and count
    the launch."""
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f'window attention kernel takes float32, bfloat16 or float16, got {q.dtype}')
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError('q, k and v must share dtype and device')
    if not math.isfinite(scale):
        raise ValueError(f'window attention needs a finite scale, got {scale}')
    if q.dtype != torch.float32 and scale <= 0:
        # the 16-bit kernel takes scale > 0; (-q) k^T (-scale) and 0 k^T are the same scores, exactly.
        # The stand-in keeps q's strides, which k and v share
        stand_in = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype, device=q.device)
        q, scale = (stand_in.copy_(-q), -scale) if scale < 0 else (stand_in.zero_(), 1.0)
    b, n, c = q.shape
    _token_strides(q, k, v)
    if b == 0 or c == 0:
        return torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    q, k, v = padded_heads(q, k, v, num_heads)
    hd = q.shape[2] // num_heads
    padded = hd != c // num_heads
    sw, st = _token_strides(q, k, v)
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    nw = 1
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
        nw = mask.shape[0]
    out = torch.empty((b, n, num_heads * hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    if q.dtype == torch.float32:
        fn, flags = lib.resselt_window_attn_f32, None
    else:
        fn = lib.resselt_window_attn_bf16 if q.dtype == torch.bfloat16 else lib.resselt_window_attn_f16
        flags = None if mask is None else mask_window_flags(mask)  # alive until the launches below
    es = q.element_size()
    kernel = ROUTE_KERNELS[('f32' if es == 4 else 'h16', lib.resselt_window_attn_route(n, hd, es))]
    ranges = _launch_ranges(b, nw, lib.resselt_window_attn_max_windows(n, num_heads, hd, es))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for w0, count, m0, mnw in ranges:
            operands = [q.data_ptr() + w0 * sw * es, k.data_ptr() + w0 * sw * es, v.data_ptr() + w0 * sw * es,
                        bias.data_ptr(), None if mask is None else mask.data_ptr() + m0 * n * n * 4]
            if q.dtype != torch.float32:
                operands.append(None if flags is None else flags.data_ptr() + m0)
            rc = fn(*operands, out.data_ptr() + w0 * n * num_heads * hd * es, count, n, num_heads, hd, st, sw, mnw,
                    float(scale), stream)
            if rc != 0:
                raise RuntimeError(f'window attention kernel launch failed: CUDA error {rc} '
                                   f'(q {tuple(q.shape)} {q.dtype}, heads {num_heads}, mask windows {nw}, '
                                   f'windows {w0} .. {w0 + count - 1})')
            window_mha.launches += 1
            window_mha.by_shape[(count, n, c, num_heads, mask is not None)] += 1
            window_mha.by_kernel[(kernel, count, n, c, num_heads, mask is not None, hd)] += 1
    if padded:
        out = out.unflatten(-1, (num_heads, hd))[..., : c // num_heads].reshape(b, n, c)
    return out


def padded_heads(q, k, v, num_heads: int):
    """q, k and v as the kernel takes them: unchanged, or in 16 bits where a
    head's rows are only 2-byte aligned, each head zero-padded to a
    multiple of 8 elements (16 bytes) in new tensors."""
    sw, st = _token_strides(q, k, v)
    hd = q.shape[2] // num_heads
    if q.dtype == torch.float32 or (q.data_ptr() | k.data_ptr() | v.data_ptr() | 2 * (sw | st | hd)) % 4 == 0:
        return q, k, v
    hp = -(-hd // 8) * 8
    return tuple(TF.pad(t.unflatten(-1, (num_heads, hd)), (0, hp - hd)).flatten(2) for t in (q, k, v))


def _launch_ranges(b: int, nw: int, max_windows: int) -> list[tuple[int, int, int, int]]:
    """The launches that cover ``b`` windows, at most ``max_windows`` each
    (the kernel's grid limit), with a mask of ``nw`` windows (1: none), as
    (first window, windows, first mask window, mask windows of the launch).
    Each launch is whole periods of the mask where a period fits in one,
    else a run inside one period, whose own mask is that run's windows."""
    if max_windows < 1:
        raise ValueError(f'window attention kernel takes no window of this shape (limit {max_windows})')
    if b <= max_windows:
        return [(0, b, 0, nw)]
    if nw <= max_windows:
        step = max_windows // nw * nw
        return [(w0, min(step, b - w0), 0, nw) for w0 in range(0, b, step)]
    return [(p0 + s0, min(max_windows, nw - s0), s0, min(max_windows, nw - s0))
            for p0 in range(0, b, nw) for s0 in range(0, nw, max_windows)]


def window_mha(q, k, v, bias, mask=None, *, num_heads: int, scale: float, head_pad: int | None = None,
               assume_padded: bool = False) -> torch.Tensor:
    """Fused window multi-head attention.

    ``q``, ``k``, ``v``: (B, N, C), B = batch x nW windows, float32,
    bfloat16 or float16; ``bias``: (heads, N, N) additive (read in f32); ``mask``:
    (nW, N, N) additive shift mask with B a multiple of nW, or None.
    Shapes outside :func:`window_mha_supported` raise ValueError.  Returns
    a contiguous (B, N, C) tensor in q's dtype.

    ``head_pad`` and ``assume_padded`` are the JAX kernel's
    (``resselt_tpu/ops/window_attention.py:96``), checked as it checks them:
    ``assume_padded`` says that every head already occupies ``head_pad``
    columns (C = heads x head_pad, ``head_pad`` dividing 128), and the
    output keeps that layout; ``head_pad`` alone pads every head with zeros
    to that many columns (at least head_dim, dividing 128).  Zero columns
    change no score and no output column, so neither changes the result."""
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'window_mha takes q, k, v of one (B, N, C) shape, got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    b, n, c = q.shape
    if not window_mha_supported(n, c, num_heads):
        raise ValueError(f'unsupported window attention: n={n} c={c} heads={num_heads}')
    if assume_padded:
        if head_pad is None or c != num_heads * head_pad or 128 % head_pad:
            raise ValueError(f'assume_padded: c={c} != heads*head_pad or bad head_pad={head_pad}')
    elif head_pad is not None and head_pad != c // num_heads:
        if head_pad < c // num_heads or 128 % head_pad:
            raise ValueError(f'head_pad {head_pad} invalid for head_dim {c // num_heads}')
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f'bias must be ({num_heads}, {n}, {n}), got {tuple(bias.shape)}')
    if mask is not None and (mask.ndim != 3 or tuple(mask.shape[1:]) != (n, n) or b % mask.shape[0]):
        raise ValueError(f'mask must be (nW, {n}, {n}) with nW dividing {b}, got {tuple(mask.shape)}')
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'window_mha runs on CPU or CUDA tensors, got {q.device}')
    return _WindowMHA.apply(q, k, v, bias, mask, num_heads, scale)


def window_mha_backward(q, k, v, bias, mask, do, *, num_heads: int, scale: float):
    """(dq, dk, dv, dbias) of :func:`window_mha_ref` for the output gradient
    ``do``, in f32 from P recomputed, in the dtypes of q and bias.  Runs on
    whole periods of the mask's windows at a time, as many as keep each
    (windows, heads, n, n) f32 tensor of a run within
    :data:`BACKWARD_CHUNK_BYTES`, and holds two such tensors at most (P, and
    dP turned into dS in place); dbias sums the runs' in f32."""
    b, n, c = q.shape
    hd = c // num_heads
    nw = 1 if mask is None else mask.shape[0]
    step = max(1, BACKWARD_CHUNK_BYTES // (4 * num_heads * n * n * nw)) * nw
    dq, dk, dv = (torch.empty((b, n, c), dtype=q.dtype, device=q.device) for _ in range(3))
    dbias = torch.zeros((num_heads, n, n), device=q.device)

    def heads(t):
        return t.float().reshape(t.shape[0], n, num_heads, hd).transpose(1, 2)

    def tokens(t):
        return t.transpose(1, 2).reshape(t.shape[0], n, c)

    for w0 in range(0, b, step):
        run = slice(w0, w0 + step)
        qh, kh, vh, doh = heads(q[run]), heads(k[run]), heads(v[run]), heads(do[run])
        s = torch.matmul(qh * scale, kh.transpose(-1, -2)) + bias.float()[None]
        if mask is not None:
            s = (s.unflatten(0, (-1, nw)) + mask.float()[None, :, None]).flatten(0, 1)
        p = torch.softmax(s, dim=-1)
        del s
        dv[run] = tokens(torch.matmul(p.transpose(-1, -2), doh))
        ds = torch.matmul(doh, vh.transpose(-1, -2))  # dP, made dS in place: P (dP - rowsum(dP P))
        ds.sub_(torch.matmul(ds.unsqueeze(-2), p.unsqueeze(-1)).squeeze(-1)).mul_(p)
        del p
        dq[run] = tokens(torch.matmul(ds, kh) * scale)
        dk[run] = tokens(torch.matmul(ds.transpose(-1, -2), qh) * scale)
        dbias += ds.sum(0)
    return dq, dk, dv, dbias.to(bias.dtype)


class _WindowMHA(torch.autograd.Function):
    """:func:`window_mha`'s forward (the kernel on the card, the plain
    version on the CPU) with :func:`window_mha_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, num_heads: int, scale: float):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(q, k, v, bias, mask)
        if q.device.type == 'cpu':
            return window_mha_ref(q, k, v, bias, mask, num_heads=num_heads, scale=scale)
        return _launch(q, k, v, bias, mask, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask = ctx.saved_tensors
        with tracing.span(BACKWARD_RANGE):
            dq, dk, dv, dbias = window_mha_backward(q, k, v, bias, mask, do, num_heads=ctx.num_heads,
                                                    scale=ctx.scale)
        return dq, dk, dv, dbias, None, None, None


window_mha.launches = 0
window_mha.by_shape = Counter()
window_mha.by_kernel = Counter()
