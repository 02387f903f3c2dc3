"""Fused same-padded convolutions + bias + activation, NHWC.

Counterpart of ``resselt_tpu/ops/fused_conv.py``'s ``fused_conv3x3_act``,
``fused_conv3x3_pack2`` and ``fused_conv_lk``.  On a CUDA tensor each
launches its hand-written Hopper kernel (``csrc/conv3x3.cu``,
``csrc/conv_lk.cu``; f32: exact FMA; bf16 and fp16: tensor cores with f32
accumulation; the output has the input's dtype) or raises; on a CPU tensor
it computes the plain version, ``*_ref`` below.  Each wrapper counts its
kernel launches in its ``launches`` attribute, and per shape in its
``by_shape`` Counter: ``(n, h, w, cin, cout, act)`` for the 3x3 wrappers,
``(n, h, w, cin, cout, k, act)`` for ``fused_conv_lk``, which also counts
``(that key, path)`` in ``by_path``: the path csrc/conv_lk.cu took for
the shape (:data:`LK_PATHS` in 16 bits), or 'f32'.

Weights are either torch OIHW ``(Cout, Cin, k, k)`` or already packed into
``(k*k, Cin, Cout)`` taps in the input's dtype (:func:`pack_conv3x3_weight`,
:func:`pack_conv_lk_weight`), the kernels' layout; model code packs once
at load.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as TF

from . import _build

ACTS = {'linear': 0, 'lrelu': 1, 'silu': 2, 'mish': 3}
_ENTRY_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16', torch.float16: 'f16'}  # the kernels' C entry points


def pack_conv_lk_weight(w_oihw: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """OIHW ``(Cout, Cin, k, k)`` -> contiguous taps ``(k*k, Cin, Cout)``,
    ``[dy * k + dx][ci][co]``, in ``dtype`` (default: the weight's)."""
    cout, cin, kh, kw = w_oihw.shape
    if kh != kw:
        raise ValueError(f'expected a square conv weight, got {tuple(w_oihw.shape)}')
    taps = w_oihw.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout)
    return taps.to(dtype or w_oihw.dtype).contiguous()


def pack_conv3x3_weight(w_oihw: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """OIHW ``(Cout, Cin, 3, 3)`` -> contiguous taps ``(9, Cin, Cout)``,
    ``[dy * 3 + dx][ci][co]``, in ``dtype`` (default: the weight's)."""
    if tuple(w_oihw.shape[2:]) != (3, 3):
        raise ValueError(f'expected a 3x3 conv weight, got {tuple(w_oihw.shape)}')
    return pack_conv_lk_weight(w_oihw, dtype)


def _taps(w: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """``w`` as ``(k*k, Cin, Cout)`` taps: OIHW is packed in ``dtype``,
    packed taps are taken as they are."""
    if w.ndim == 4 and tuple(w.shape[2:]) == (k, k):
        return pack_conv_lk_weight(w, dtype)
    if w.ndim == 3 and w.shape[0] == k * k:
        return w
    raise ValueError(f'weight must be OIHW (Cout, Cin, {k}, {k}) or packed ({k * k}, Cin, Cout), '
                     f'got {tuple(w.shape)}')


def _act_ref(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == 'linear':
        return y
    if act == 'lrelu':
        return torch.where(y >= 0, y, 0.2 * y)
    if act == 'silu':
        return y * torch.sigmoid(y)
    if act == 'mish':
        return y * torch.tanh(TF.softplus(y))
    raise ValueError(f'unknown activation {act!r}')


def _conv_ref(x, w, k: int, b, act: str) -> torch.Tensor:
    """``torch.nn.functional.conv2d`` with padding ``k // 2`` in f32, plus
    bias and activation, cast back to ``x``'s dtype."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    taps = _taps(w, k, w.dtype).float()
    cin, cout = taps.shape[1], taps.shape[2]
    w_oihw = taps.reshape(k, k, cin, cout).permute(3, 2, 0, 1)
    y = TF.conv2d(x.float().permute(0, 3, 1, 2), w_oihw, None, padding=k // 2)
    if b is not None:
        y = y + b.float()[None, :, None, None]
    y = _act_ref(y, act).permute(0, 2, 3, 1).to(x.dtype).contiguous()
    return y[0] if squeeze else y


def fused_conv3x3_act_ref(x, w, b=None, act: str = 'linear') -> torch.Tensor:
    """Plain version: ``torch.nn.functional.conv2d`` with padding 1 in f32,
    plus bias and activation, cast back to ``x``'s dtype."""
    return _conv_ref(x, w, 3, b, act)


def fused_conv3x3_pack2_ref(x, w, b=None, act: str = 'linear') -> torch.Tensor:
    """Plain version of :func:`fused_conv3x3_pack2` (the same function)."""
    return fused_conv3x3_act_ref(x, w, b, act)


def _kernel_weights(x: torch.Tensor, w: torch.Tensor, k: int, b):
    """The taps and f32 bias a kernel reads for input ``x``, checked: taps
    contiguous, on ``x``'s device, in its dtype, for its channels."""
    taps = _taps(w, k, x.dtype)
    if taps.dtype != x.dtype or taps.device != x.device or not taps.is_contiguous():
        raise ValueError('packed weight must be contiguous, on the input device, in the input dtype')
    if taps.shape[1] != x.shape[-1]:
        raise ValueError(f'weight takes {taps.shape[1]} input channels, input has {x.shape[-1]}')
    cout = taps.shape[2]
    if b is not None:
        b = b.float()
        if b.shape != (cout,) or b.device != x.device or not b.is_contiguous():
            raise ValueError(f'bias must be a contiguous ({cout},) tensor on the input device')
    return taps, b


def _lib() -> ctypes.CDLL:
    lib = _build.load('conv3x3')
    if not getattr(lib, '_resselt_typed', False):
        for fn in (lib.resselt_conv3x3_f32, lib.resselt_conv3x3_bf16, lib.resselt_conv3x3_f16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._resselt_typed = True
    return lib


def _launch(entry, x: torch.Tensor, w: torch.Tensor, b, act: str) -> torch.Tensor:
    """Check the operands, launch the kernel on the current stream and count
    the launch on ``entry``, the wrapper that asked for it."""
    if x.dtype not in _ENTRY_SUFFIX:
        raise TypeError(f'conv3x3 kernel takes float32, bfloat16 or float16 input, got {x.dtype}')
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f'conv3x3 kernel needs a contiguous NHWC tensor, got shape {tuple(x.shape)}')
    if act not in ACTS:
        raise ValueError(f'unknown activation {act!r}')
    n, h, wd, cin = x.shape
    taps, b = _kernel_weights(x, w, 3, b)
    cout = taps.shape[2]
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    fn = getattr(lib, 'resselt_conv3x3_' + _ENTRY_SUFFIX[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), taps.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
                n, h, wd, cin, cout, ACTS[act], stream)
    if rc != 0:
        raise RuntimeError(f'conv3x3 kernel launch failed: CUDA error {rc} '
                           f'(x {tuple(x.shape)} {x.dtype}, cout {cout}, act {act})')
    entry.launches += 1
    entry.by_shape[(n, h, wd, cin, cout, act)] += 1
    return y


def fused_conv3x3_act(x, w, b=None, act: str = 'linear') -> torch.Tensor:
    """Fused same-padded 3x3 conv + bias + activation.

    ``x``: (H, W, Cin) or (N, H, W, Cin), float32, bfloat16 or float16;
    ``w``: OIHW or packed taps; ``b``: (Cout,) or None; ``act``: linear, lrelu (0.2),
    silu or mish.  Output: ``x``'s dtype, ``F.conv2d(x, w, b, padding=1)``
    + activation computed with f32 accumulation."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if x.device.type == 'cpu':
        y = fused_conv3x3_act_ref(x, w, b, act)
    elif x.device.type == 'cuda':
        y = _launch(fused_conv3x3_act, x, w, b, act)
    else:
        raise ValueError(f'fused_conv3x3_act runs on CPU or CUDA tensors, got {x.device}')
    return y[0] if squeeze else y


fused_conv3x3_act.launches = 0
fused_conv3x3_act.by_shape = Counter()


def fused_conv3x3_pack2(x, w, b=None, act: str = 'linear') -> torch.Tensor:
    """The same function as :func:`fused_conv3x3_act` behind the JAX
    package's C <= 64 entry and its shape checks: cin, cout <= 64 and an
    even width, else ValueError."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    taps_shape = (w.shape[1], w.shape[0]) if w.ndim == 4 else (w.shape[1], w.shape[2])
    if max(taps_shape) > 64:
        raise ValueError('pack2 kernel requires cin, cout <= 64')
    if x.shape[2] % 2:
        raise ValueError('pack2 kernel requires even width')
    if x.device.type == 'cpu':
        y = fused_conv3x3_pack2_ref(x, w, b, act)
    elif x.device.type == 'cuda':
        y = _launch(fused_conv3x3_pack2, x, w, b, act)
    else:
        raise ValueError(f'fused_conv3x3_pack2 runs on CPU or CUDA tensors, got {x.device}')
    return y[0] if squeeze else y


fused_conv3x3_pack2.launches = 0
fused_conv3x3_pack2.by_shape = Counter()


# -- large-kernel conv (PLKSR's partial conv) ---------------------------------

LK_MAX_K = 31  # csrc/conv_lk.cu: the mma.sync path's halo + one weight row fit in shared memory up to here
# csrc/conv_lk.cu's 16-bit paths, in its enum Path's order: stacked (Cin 16,
# Cout <= 16, all weights resident), tiles (Cin 16 and 64), mma (the rest)
LK_PATHS = ('mma', 'stacked', 'tiles')


def lk_conv_supported(cin: int, cout: int, k: int) -> bool:
    """Shapes :func:`fused_conv_lk` (and its kernel) take: cin in {8, 16, 32,
    64}, 0 < cout <= cin, k odd and at most 31.  The JAX package's
    predicate, bounded in k."""
    return cin in (8, 16, 32, 64) and 0 < cout <= cin and k % 2 == 1 and 0 < k <= LK_MAX_K


def fused_conv_lk_ref(x, w, b=None, k: int = 17, act: str = 'linear') -> torch.Tensor:
    """Plain version: ``torch.nn.functional.conv2d`` with padding ``k // 2``
    in f32, plus bias and activation, cast back to ``x``'s dtype."""
    return _conv_ref(x, w, k, b, act)


def _lk_lib() -> ctypes.CDLL:
    lib = _build.load('conv_lk')
    if not getattr(lib, '_resselt_typed', False):
        for fn in (lib.resselt_conv_lk_f32, lib.resselt_conv_lk_bf16, lib.resselt_conv_lk_f16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.resselt_conv_lk_path.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.resselt_conv_lk_path.restype = ctypes.c_int
        lib._resselt_typed = True
    return lib


def _pixel_pitch(x: torch.Tensor) -> int:
    """Elements between neighbouring pixels of NHWC ``x``, whose pixels
    must lie at one pitch with their channels next to each other (a
    contiguous tensor, or a channel slice ``t[..., a:b]`` of one)."""
    n, h, w, c = x.shape
    pitch = x.stride(2)
    if x.stride(3) != 1 or pitch < c or x.stride(1) != w * pitch or x.stride(0) != h * w * pitch:
        raise ValueError(f'lk kernel needs NHWC pixels at one pitch (a contiguous tensor or a channel '
                         f'slice of one), got shape {tuple(x.shape)} strides {x.stride()}')
    return pitch


def _launch_lk(x: torch.Tensor, w: torch.Tensor, b, k: int, act: str) -> torch.Tensor:
    """Check the operands, launch the lk kernel on the current stream and
    count the launch."""
    if x.dtype not in _ENTRY_SUFFIX:
        raise TypeError(f'lk kernel takes float32, bfloat16 or float16 input, got {x.dtype}')
    n, h, wd, cin = x.shape
    pitch = _pixel_pitch(x)
    taps, b = _kernel_weights(x, w, k, b)
    cout = taps.shape[2]
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lk_lib()
    fn = getattr(lib, 'resselt_conv_lk_' + _ENTRY_SUFFIX[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), taps.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
                n, h, wd, cin, cout, pitch, k, ACTS[act], stream)
    path = 'f32' if x.dtype == torch.float32 else LK_PATHS[lib.resselt_conv_lk_path(cin, cout, k, pitch, x.data_ptr())]
    if rc != 0:
        raise RuntimeError(f'lk kernel launch failed: CUDA error {rc} '
                           f'(x {tuple(x.shape)} {x.dtype}, cout {cout}, k {k}, act {act}, path {path})')
    key = (n, h, wd, cin, cout, k, act)
    fused_conv_lk.launches += 1
    fused_conv_lk.by_shape[key] += 1
    fused_conv_lk.by_path[(key, path)] += 1
    return y


def fused_conv_lk(x, w, b=None, k: int = 17, act: str = 'linear') -> torch.Tensor:
    """Fused same-padded k x k conv + bias + activation for few-channel
    slabs (PLKSR's partial large-kernel conv).

    ``x``: (H, W, Cin) or (N, H, W, Cin), float32, bfloat16 or float16; a channel
    slice ``t[..., a:a + Cin]`` of a contiguous NHWC tensor is read in
    place.  ``w``: OIHW ``(Cout, Cin, k, k)`` or packed taps; ``b``:
    (Cout,) or None; ``act``: linear or lrelu (0.2).  Shapes outside
    :func:`lk_conv_supported` raise ValueError, as JAX's.  Output:
    contiguous, in ``x``'s dtype, accumulated in f32."""
    if act not in ('linear', 'lrelu'):
        raise ValueError(f"fused_conv_lk supports act 'linear'/'lrelu', got {act!r}")
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if x.ndim != 4:
        raise ValueError(f'fused_conv_lk takes (H, W, C) or (N, H, W, C), got shape {tuple(x.shape)}')
    cin = x.shape[-1]
    cout = w.shape[0] if w.ndim == 4 else w.shape[-1]
    if not lk_conv_supported(cin, cout, k):
        raise ValueError(f'unsupported lk conv: cin={cin} cout={cout} k={k}')
    if x.device.type == 'cpu':
        y = fused_conv_lk_ref(x, w, b, k, act)
    elif x.device.type == 'cuda':
        y = _launch_lk(x, w, b, k, act)
    else:
        raise ValueError(f'fused_conv_lk runs on CPU or CUDA tensors, got {x.device}')
    return y[0] if squeeze else y


fused_conv_lk.launches = 0
fused_conv_lk.by_shape = Counter()
fused_conv_lk.by_path = Counter()
