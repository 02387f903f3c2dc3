"""Overlapping cross-window attention with an additive bias: HAT's OCAB.

For every window and head it computes

    O = softmax(scale * Q K^T + bias[h]) V

with N queries and M keys a window (HAT: a 16 x 16 window's 256 queries
against the 576 keys of the 24 x 24 window around it), the scores, bias and
softmax in f32 and the output in the input's dtype.  There is no mask.  On
a CUDA tensor :func:`window_cross_mha` launches the hand-written Hopper
kernel ``csrc/window_cross_attn.cu`` (bf16 and fp16: a producer and two
consumer warpgroups on wgmma, the bias rows in shared memory, the keys in
chunks with an online softmax; the scores never reach device memory) or
raises; on a CPU tensor it computes the plain version
:func:`window_cross_mha_ref`.  The JAX package
has no kernel for it: it runs OCAB in XLA, as ``nn/window.py``'s plain path
does here for f32, the CPU and training.

q may be read in place from a window-partitioned projection and k and v as
the two channel halves ``patches[..., :C]`` and ``patches[..., C:]`` of one
``(B, M, 2C)`` tensor of overlapping windows: the kernel takes q's token and
window pitches, and k's and v's (shared), as they are.

The wrapper counts its kernel launches in ``window_cross_mha.launches``, and
per shape in the ``window_cross_mha.by_shape`` Counter under ``(windows, n,
m, c, heads)``.  It records no span: OCAB runs inside the tiled driver's
CUDA graph replays, where no host code runs.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from . import _build

MAX_KEYS = 576  # csrc/window_cross_attn.cu's MAX_KEYS: the keys its bias rows hold, HAT's 24 x 24 window
MAX_HEAD_DIM = 32


def window_cross_mha_supported(n: int, m: int, c: int, num_heads: int) -> bool:
    """Shapes the kernel takes, in 16 bits (``resselt_window_cross_attn_supported``'s
    rule): n >= 1 queries, 1 <= m <= :data:`MAX_KEYS` keys, C a multiple of
    heads with an even head_dim of at most :data:`MAX_HEAD_DIM`."""
    if num_heads < 1 or c % num_heads:
        return False
    hd = c // num_heads
    return n >= 1 and 1 <= m <= MAX_KEYS and 2 <= hd <= MAX_HEAD_DIM and hd % 2 == 0


def window_cross_mha_ref(q, k, v, bias, *, num_heads: int, scale: float) -> torch.Tensor:
    """Plain version, with ``window_mha_ref``'s semantics: q, k, v taken to
    f32, q scaled in f32, scores + bias and the softmax in f32, P V in f32,
    cast back to q's dtype.  In f32 this is the plain path's
    (``nn.window._mha_plain``) attention; in bf16 it does not round the
    scores to bf16 first, as the plain path does."""
    b, n, c = q.shape
    m = k.shape[1]
    hd = c // num_heads

    def heads(t, rows):
        return t.float().reshape(b, rows, num_heads, hd).transpose(1, 2)

    s = torch.matmul(heads(q, n) * scale, heads(k, m).transpose(-1, -2)) + bias.float()[None]
    o = torch.matmul(torch.softmax(s, dim=-1), heads(v, m))
    return o.transpose(1, 2).reshape(b, n, c).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load('window_cross_attn')
    if not getattr(lib, '_resselt_typed', False):
        for fn in (lib.resselt_window_cross_attn_bf16, lib.resselt_window_cross_attn_f16):
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.resselt_window_cross_attn_supported.argtypes = [ctypes.c_int] * 4
        lib.resselt_window_cross_attn_supported.restype = ctypes.c_int
        lib._resselt_typed = True
    return lib


def _pitches(t, name: str) -> tuple[int, int]:
    """(window stride, token stride) in elements of a (B, rows, C) operand
    whose channels lie next to each other."""
    sw, st, sc = t.stride()
    if sc != 1 or st < t.shape[2] or sw < t.shape[1] * st:
        raise ValueError(f'cross attention kernel needs {name}\'s tokens at one pitch with channels next to each '
                         f'other, got shape {tuple(t.shape)} strides {(sw, st, sc)}')
    return sw, st


def _launch(q, k, v, bias, num_heads: int, scale: float) -> torch.Tensor:
    """Check the operands, launch the kernel on the current stream and count
    the launch."""
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f'cross attention kernel takes bfloat16 or float16, got {q.dtype}')
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError('q, k and v must share dtype and device')
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        raise ValueError('cross attention kernel computes no gradient; run the plain version')
    if not (math.isfinite(scale) and scale > 0):
        raise ValueError(f'cross attention kernel needs a finite scale > 0, got {scale}')
    b, n, c = q.shape
    m = k.shape[1]
    hd = c // num_heads
    wsq, ldq = _pitches(q, 'q')
    wskv, ldkv = _pitches(k, 'k')
    if _pitches(v, 'v') != (wskv, ldkv):
        raise ValueError(f'cross attention kernel needs k and v at the same strides, got {k.stride()} and '
                         f'{v.stride()}')
    lib = _lib()
    if not lib.resselt_window_cross_attn_supported(n, m, hd, q.element_size()):
        raise ValueError(f'cross attention kernel takes no such shape: n={n} m={m} head_dim={hd}')
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    fn = lib.resselt_window_cross_attn_bf16 if q.dtype == torch.bfloat16 else lib.resselt_window_cross_attn_f16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n, m, num_heads, hd,
                ldq, wsq, ldkv, wskv, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f'cross attention kernel launch failed: CUDA error {rc} (q {tuple(q.shape)} {q.dtype}, '
                           f'k {tuple(k.shape)}, heads {num_heads})')
    window_cross_mha.launches += 1
    window_cross_mha.by_shape[(b, n, m, c, num_heads)] += 1
    return out


def window_cross_mha(q, k, v, bias, *, num_heads: int, scale: float) -> torch.Tensor:
    """Fused overlapping cross-window multi-head attention.

    ``q``: (B, N, C); ``k``, ``v``: (B, M, C), bfloat16 or float16 on the
    card (any float type on the CPU); ``bias``: (heads, N, M) additive, read
    in f32.  Returns a contiguous (B, N, C) tensor in q's dtype.  On the
    card, shapes outside :func:`window_cross_mha_supported`, f32, a
    gradient asked for and a scale that is not positive raise."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f'window_cross_mha takes q (B, N, C) and k, v (B, M, C), got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    b, n, c = q.shape
    m = k.shape[1]
    if num_heads < 1 or c % num_heads:
        raise ValueError(f'C={c} is not a multiple of heads={num_heads}')
    if tuple(bias.shape) != (num_heads, n, m):
        raise ValueError(f'bias must be ({num_heads}, {n}, {m}), got {tuple(bias.shape)}')
    if q.device.type == 'cpu':
        return window_cross_mha_ref(q, k, v, bias, num_heads=num_heads, scale=scale)
    if q.device.type != 'cuda':
        raise ValueError(f'window_cross_mha runs on CPU or CUDA tensors, got {q.device}')
    return _launch(q, k, v, bias, num_heads, scale)


window_cross_mha.launches = 0
window_cross_mha.by_shape = Counter()
