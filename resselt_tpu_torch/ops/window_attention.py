"""Window multi-head attention with an additive bias and shift mask.

Counterpart of ``resselt_tpu/ops/window_attention.py``'s
``window_mha_pallas``.  For every window and head it computes

    O = softmax(scale * Q K^T + bias[h] + mask[w mod nW]) V

with the scores, bias, mask and softmax in f32 and the output in the
input's dtype.  On a CUDA tensor :func:`window_mha` launches the
hand-written Hopper kernel ``csrc/window_attn.cu`` (f32: exact FMA; bf16 and
fp16: tensor cores with f32 accumulation and an online softmax, persistent
blocks that keep their bias rows in shared memory and skip all-zero mask
windows) or raises; on a CPU tensor it computes the plain version
:func:`window_mha_ref`.  The
wrapper counts its kernel launches in ``window_mha.launches``, and per
shape in the ``window_mha.by_shape`` Counter under ``(windows, n, c,
heads, masked)``.

q, k and v may be the three channel slices ``qkv[..., :C]``,
``qkv[..., C:2C]``, ``qkv[..., 2C:]`` of one ``(B, N, 3C)`` projection:
the kernel reads them in place through their token pitch.  In bf16 and
fp16 a head whose rows are only 2-byte aligned (an odd head_dim, as DRCT's
53) is first copied into heads zero-padded to a multiple of 8 elements:
the kernel stages such rows with 2-byte loads, which took 30.3 ms at
DRCT's bench shape against 9.2 ms for head_dim 46 on an H100.  The padding
changes no score and no output column.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from collections import Counter

import torch
import torch.nn.functional as TF

from . import _build

WATTN_MAX_N = 256  # csrc/window_attn.cu: tokens per window (padded to 16 inside)
WATTN_MAX_HEAD_DIM = 64  # csrc/window_attn.cu: head_dim (padded to 16 inside)


def window_mha_supported(n: int, c: int, num_heads: int) -> bool:
    """Shapes :func:`window_mha` (and its kernel) take: 1 <= n <= 256
    tokens per window and C = heads x head_dim with head_dim <= 64."""
    return (1 <= n <= WATTN_MAX_N and num_heads >= 1 and c % num_heads == 0
            and 1 <= c // num_heads <= WATTN_MAX_HEAD_DIM)


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
    hd = c // num_heads
    sw, st = _token_strides(q, k, v)
    if b == 0:
        return torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    padded = q.dtype != torch.float32 and (q.data_ptr() | k.data_ptr() | v.data_ptr() | 2 * (sw | st | hd)) % 4
    if padded:  # rows only 2-byte aligned: zero-pad each head to a multiple of 8 elements (16 bytes)
        hd = -(-hd // 8) * 8
        q, k, v = (TF.pad(t.unflatten(-1, (num_heads, c // num_heads)), (0, hd - c // num_heads)).flatten(2)
                   for t in (q, k, v))
        sw, st = _token_strides(q, k, v)
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    nw = 1
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
        nw = mask.shape[0]
    out = torch.empty((b, n, num_heads * hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    operands = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr()]
    if q.dtype == torch.float32:
        fn = lib.resselt_window_attn_f32
    else:
        fn = lib.resselt_window_attn_bf16 if q.dtype == torch.bfloat16 else lib.resselt_window_attn_f16
        flags = None if mask is None else mask_window_flags(mask)  # alive until the launch below
        operands.append(None if flags is None else flags.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*operands, out.data_ptr(), b, n, num_heads, hd, st, sw, nw, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f'window attention kernel launch failed: CUDA error {rc} '
                           f'(q {tuple(q.shape)} {q.dtype}, heads {num_heads}, mask windows {nw})')
    window_mha.launches += 1
    window_mha.by_shape[(b, n, c, num_heads, mask is not None)] += 1
    if padded:
        out = out.unflatten(-1, (num_heads, hd))[..., : c // num_heads].reshape(b, n, c)
    return out


def window_mha(q, k, v, bias, mask=None, *, num_heads: int, scale: float) -> torch.Tensor:
    """Fused window multi-head attention.

    ``q``, ``k``, ``v``: (B, N, C), B = batch x nW windows, float32,
    bfloat16 or float16; ``bias``: (heads, N, N) additive (read in f32); ``mask``:
    (nW, N, N) additive shift mask with B a multiple of nW, or None.
    Shapes outside :func:`window_mha_supported` raise ValueError.  Returns
    a contiguous (B, N, C) tensor in q's dtype."""
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'window_mha takes q, k, v of one (B, N, C) shape, got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    b, n, c = q.shape
    if not window_mha_supported(n, c, num_heads):
        raise ValueError(f'unsupported window attention: n={n} c={c} heads={num_heads}')
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f'bias must be ({num_heads}, {n}, {n}), got {tuple(bias.shape)}')
    if mask is not None and (mask.ndim != 3 or tuple(mask.shape[1:]) != (n, n) or b % mask.shape[0]):
        raise ValueError(f'mask must be (nW, {n}, {n}) with nW dividing {b}, got {tuple(mask.shape)}')
    if q.device.type == 'cpu':
        return window_mha_ref(q, k, v, bias, mask, num_heads=num_heads, scale=scale)
    if q.device.type == 'cuda':
        return _launch(q, k, v, bias, mask, num_heads, scale)
    raise ValueError(f'window_mha runs on CPU or CUDA tensors, got {q.device}')


window_mha.launches = 0
window_mha.by_shape = Counter()
