"""Fused same-padded 3x3 convolution + bias + activation, NHWC.

Counterpart of ``resselt_tpu/ops/fused_conv.py``'s ``fused_conv3x3_act``
and ``fused_conv3x3_pack2``.  On a CUDA tensor both launch the hand-written
Hopper kernel in ``csrc/conv3x3.cu`` (f32: exact FMA; bf16: tensor cores
with f32 accumulation; the output has the input's dtype) or raise; on a
CPU tensor they compute the plain version, ``*_ref`` below.  Each wrapper
counts its kernel launches in its ``launches`` attribute, and per
``(n, h, w, cin, cout, act)`` in its ``by_shape`` Counter.

Weights are either torch OIHW ``(Cout, Cin, 3, 3)`` or already packed by
:func:`pack_conv3x3_weight` into ``(9, Cin, Cout)`` taps in the input's
dtype, the kernel's layout; model code packs once at load.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as TF

from . import _build

ACTS = {'linear': 0, 'lrelu': 1, 'silu': 2, 'mish': 3}


def pack_conv3x3_weight(w_oihw: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """OIHW ``(Cout, Cin, 3, 3)`` -> contiguous taps ``(9, Cin, Cout)``,
    ``[dy * 3 + dx][ci][co]``, in ``dtype`` (default: the weight's)."""
    cout, cin, kh, kw = w_oihw.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f'expected a 3x3 conv weight, got {tuple(w_oihw.shape)}')
    taps = w_oihw.permute(2, 3, 1, 0).reshape(9, cin, cout)
    return taps.to(dtype or w_oihw.dtype).contiguous()


def _taps(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if w.ndim == 4:
        return pack_conv3x3_weight(w, dtype)
    if w.ndim == 3 and w.shape[0] == 9:
        return w
    raise ValueError(f'weight must be OIHW (Cout, Cin, 3, 3) or packed (9, Cin, Cout), got {tuple(w.shape)}')


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


def fused_conv3x3_act_ref(x, w, b=None, act: str = 'linear') -> torch.Tensor:
    """Plain version: ``torch.nn.functional.conv2d`` with padding 1 in f32,
    plus bias and activation, cast back to ``x``'s dtype."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    taps = _taps(w, w.dtype).float()
    cin, cout = taps.shape[1], taps.shape[2]
    w_oihw = taps.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    y = TF.conv2d(x.float().permute(0, 3, 1, 2), w_oihw, None, padding=1)
    if b is not None:
        y = y + b.float()[None, :, None, None]
    y = _act_ref(y, act).permute(0, 2, 3, 1).to(x.dtype).contiguous()
    return y[0] if squeeze else y


def fused_conv3x3_pack2_ref(x, w, b=None, act: str = 'linear') -> torch.Tensor:
    """Plain version of :func:`fused_conv3x3_pack2` (the same function)."""
    return fused_conv3x3_act_ref(x, w, b, act)


def _lib() -> ctypes.CDLL:
    lib = _build.load('conv3x3')
    if not getattr(lib, '_resselt_typed', False):
        for fn in (lib.resselt_conv3x3_f32, lib.resselt_conv3x3_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._resselt_typed = True
    return lib


def _launch(entry, x: torch.Tensor, w: torch.Tensor, b, act: str) -> torch.Tensor:
    """Check the operands, launch the kernel on the current stream and count
    the launch on ``entry``, the wrapper that asked for it."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'conv3x3 kernel takes float32 or bfloat16 input, got {x.dtype}')
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f'conv3x3 kernel needs a contiguous NHWC tensor, got shape {tuple(x.shape)}')
    if act not in ACTS:
        raise ValueError(f'unknown activation {act!r}')
    n, h, wd, cin = x.shape
    taps = _taps(w, x.dtype)
    if taps.dtype != x.dtype or taps.device != x.device or not taps.is_contiguous():
        raise ValueError('packed weight must be contiguous, on the input device, in the input dtype')
    if taps.shape[1] != cin:
        raise ValueError(f'weight takes {taps.shape[1]} input channels, input has {cin}')
    cout = taps.shape[2]
    if b is not None:
        b = b.float()
        if b.shape != (cout,) or b.device != x.device or not b.is_contiguous():
            raise ValueError(f'bias must be a contiguous ({cout},) tensor on the input device')
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    fn = lib.resselt_conv3x3_bf16 if x.dtype == torch.bfloat16 else lib.resselt_conv3x3_f32
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

    ``x``: (H, W, Cin) or (N, H, W, Cin), float32 or bfloat16; ``w``: OIHW
    or packed taps; ``b``: (Cout,) or None; ``act``: linear, lrelu (0.2),
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
