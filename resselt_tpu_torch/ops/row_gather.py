"""Indexed row gather: ``out[j, :] = src[idx[j], :]``, bit-exact.

Counterpart of ``tools/probe_acmsa_gather.py``'s ``tile_gather``, the row
shuffle the JAX package wrote for ATD's AC_MSA (the qkv rows into
category-sorted order, the attention output back through the inverted
permutation).  On a CUDA tensor :func:`row_gather` launches the hand-written
Hopper kernel ``csrc/row_gather.cu`` or raises; on a CPU tensor it computes
the plain version :func:`row_gather_ref`.  The wrapper counts its kernel
launches in ``row_gather.launches``, and per shape in the
``row_gather.by_shape`` Counter under ``(rows_out, rows_src, width, dtype)``.

``src`` may be a row slice or a column slice of a wider matrix: the kernel
reads its rows in place through their pitch.

:func:`row_gather` carries a gradient (:class:`_RowGather`, on both
devices): ``zeros.index_add_(0, idx, dout)``, which sums the rows of an
index that repeats.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import _build


def row_gather_ref(src, idx) -> torch.Tensor:
    """Plain version: ``src.index_select(0, idx)``."""
    return src.index_select(0, idx)


def _lib() -> ctypes.CDLL:
    lib = _build.load('row_gather')
    if not getattr(lib, '_resselt_typed', False):
        lib.resselt_row_gather.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
                                           + [ctypes.c_int, ctypes.c_void_p])
        lib.resselt_row_gather.restype = ctypes.c_int
        lib._resselt_typed = True
    return lib


def _launch(src, idx) -> torch.Tensor:
    """Check the operands, launch the kernel on the current stream and count
    the launch."""
    if src.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f'row gather kernel takes float32, bfloat16 or float16 rows, got {src.dtype}')
    if idx.device != src.device:
        raise ValueError(f'src and idx must share a device, got {src.device} and {idx.device}')
    rows_src, width = src.shape
    rows_out = idx.shape[0]
    out = torch.empty((rows_out, width), dtype=src.dtype, device=src.device)
    if rows_out == 0 or width == 0:
        return out
    if rows_src == 0:
        raise IndexError('row_gather: indices into a source without rows')
    pitch = src.stride(0) if rows_src > 1 else width
    if (width > 1 and src.stride(1) != 1) or pitch < width:
        raise ValueError(f'row gather kernel needs rows at one pitch with their elements next to each other, '
                         f'got shape {tuple(src.shape)} strides {src.stride()}')
    idx = idx.contiguous()
    size = src.element_size()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = _lib().resselt_row_gather(src.data_ptr(), idx.data_ptr(), out.data_ptr(), rows_out, rows_src,
                                       width * size, pitch * size, int(idx.dtype == torch.int64), stream)
    if rc != 0:
        raise RuntimeError(f'row gather kernel launch failed: CUDA error {rc} '
                           f'(src {tuple(src.shape)} {src.dtype}, {rows_out} indices {idx.dtype})')
    row_gather.launches += 1
    row_gather.by_shape[(rows_out, rows_src, width, str(src.dtype).removeprefix('torch.'))] += 1
    return out


def row_gather(src, idx) -> torch.Tensor:
    """Rows of ``src`` (R, C), float32, bfloat16 or float16, picked by ``idx`` (R',),
    int32 or int64 with values in [0, R): a contiguous (R', C) tensor,
    ``out[j] = src[idx[j]]``.  An index may repeat.  On the card an index
    outside [0, R) stops the kernel with a device-side trap."""
    if src.ndim != 2 or idx.ndim != 1:
        raise ValueError(f'row_gather takes src (R, C) and idx (R\',), got {tuple(src.shape)} and {tuple(idx.shape)}')
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f'row_gather takes int32 or int64 indices, got {idx.dtype}')
    if src.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'row_gather runs on CPU or CUDA tensors, got {src.device}')
    return _RowGather.apply(src, idx)


class _RowGather(torch.autograd.Function):
    """:func:`row_gather`'s forward (the kernel on the card, the plain
    version on the CPU) with the scatter-add of the output gradient."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.rows_src = src.shape[0]
        ctx.save_for_backward(idx)
        return row_gather_ref(src, idx) if src.device.type == 'cpu' else _launch(src, idx)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        dsrc = dout.new_zeros((ctx.rows_src, dout.shape[1])).index_add_(0, idx, dout)
        return dsrc, None


row_gather.launches = 0
row_gather.by_shape = Counter()
