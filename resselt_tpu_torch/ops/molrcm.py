"""EIMN's MOLRCM attention, fused into one kernel.

Counterpart of ``resselt_tpu/ops/molrcm.py``'s ``fused_molrcm``.  For NHWC
``x`` with ``dim`` channels, split ``c1 = 3/8 dim``, ``c2 = 1/8 dim`` and
the rest ``c3``, it computes

    value = Wv x + bv ;  q = gelu(Wq x + bq) ;  r = dw5x5(q) + br
    f     = [dw5x5_dil2(r[:c1]) + b1, r[c1:c1+c2], dw7x7_dil3(r[c1+c2:]) + b2]
    out   = Wo (silu(Wf f + bf) * value) + bo

in f32, with every depthwise conv zero-padding its own input, and returns
it in ``x``'s dtype.  On a CUDA tensor :func:`fused_molrcm` launches the
hand-written Hopper kernel ``csrc/molrcm.cu`` (dim 64 only; f32 FMA in f32;
in bf16 and fp16 a block per SM walks 16-column strips of the image, with
the four products on the tensor cores) or raises; on a CPU tensor it
computes the plain version :func:`fused_molrcm_ref`.  Both read the
weights from the one f32 buffer
:func:`pack_molrcm_weights` builds.  The wrapper counts its kernel launches
in ``fused_molrcm.launches``, and per shape in the ``fused_molrcm.by_shape``
Counter under ``(n, h, w, dim, dtype name)``.

:func:`fused_molrcm` carries a gradient (:class:`_MOLRCM`, on both
devices): the backward recomputes the chain with :func:`fused_molrcm_ref`
under autograd and back-propagates through it, into ``x`` and the packed
buffer, and from there to the params that :func:`pack_molrcm_weights` read.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as TF

from ..nn import functional as F
from . import _build

MOLRCM_DIM = 64  # csrc/molrcm.cu: the one width the kernel takes


def molrcm_supported(dim: int, h: int, w: int) -> bool:
    """The JAX package's gate (``resselt_tpu/ops/molrcm.py:184``): the
    channel split points 8-aligned and dim <= 64, which leaves dim 64
    alone, on any image of at least one pixel."""
    c1, c2, _ = _splits(dim)
    if dim % 8 or c1 % 8 or (c1 + c2) % 8:
        return False
    return not (dim > 64 or w < 1 or h < 1)


def _splits(dim: int) -> tuple[int, int, int]:
    """(c1, c2, c3): the dil-2, pass-through and dil-3 channel counts."""
    c1, c2 = int(3 / 8 * dim), int(1 / 8 * dim)
    return c1, c2, dim - c1 - c2


def _layout(dim: int) -> list[tuple[str, tuple[int, ...]]]:
    """The packed buffer, in order: 1x1 weights as torch's [c_out][k],
    depthwise taps as [dy * K + dx][c], each followed by its bias (the
    order csrc/molrcm.cu's W_* offsets hard-code for dim 64)."""
    c1, _, c3 = _splits(dim)
    return [('wq', (dim, dim)), ('bq', (dim,)), ('wv', (dim, dim)), ('bv', (dim,)),
            ('wr', (25, dim)), ('br', (dim,)), ('w1', (25, c1)), ('b1', (c1,)),
            ('w2', (49, c3)), ('b2', (c3,)), ('wf', (dim, dim)), ('bf', (dim,)),
            ('wo', (dim, dim)), ('bo', (dim,))]


def packed_size(dim: int) -> int:
    return sum(torch.Size(shape).numel() for _, shape in _layout(dim))


def pack_molrcm_weights(p, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The MOLRCM weights of ``p`` (a PTree scoped to the attention module)
    rounded to ``dtype`` and held in one f32 buffer in the kernel's layout.
    Biases are optional, as the JAX package's ``_wb`` allows (zero when
    absent)."""
    dim = p.shape('proj_value.0.weight')[0]

    def rounded(t):
        return t.to(dtype).float()

    parts = {}
    for key, name, depthwise in (('q', 'proj_query.0', False), ('v', 'proj_value.0', False), ('r', 'region', True),
                                 ('1', 'spatial_1', True), ('2', 'spatial_2', True), ('f', 'fusion', False),
                                 ('o', 'out', False)):
        w, b = p.wb(name)
        w = rounded(w.reshape(w.shape[0], -1))  # 1x1: (c_out, k); depthwise: (c, K * K)
        parts['w' + key] = w.t() if depthwise else w
        parts['b' + key] = torch.zeros(w.shape[0], device=w.device) if b is None else rounded(b)
    flat = []
    for name, shape in _layout(dim):
        if tuple(parts[name].shape) != shape:
            raise ValueError(f'MOLRCM weight {name}: shape {tuple(parts[name].shape)}, expected {shape}')
        flat.append(parts[name].reshape(-1))
    return torch.cat(flat).contiguous()


def _unpack(packed: torch.Tensor, dim: int) -> dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in _layout(dim):
        n = torch.Size(shape).numel()
        out[name] = packed[at:at + n].reshape(shape)
        at += n
    return out


def fused_molrcm_ref(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Plain version, with the JAX kernel's semantics (``_run`` takes x to
    f32 and casts back): the ``_molrcm`` chain in f32 on ``x`` cast to f32,
    from the packed weights, cast back to ``x``'s dtype."""
    dim = x.shape[-1]
    c1, c2, c3 = _splits(dim)
    u = _unpack(packed.to(device=x.device, dtype=torch.float32), dim)
    xf = x.float()

    def dw(t, taps, bias, k, dilation):
        c = t.shape[-1]
        return F.conv2d(t, taps.t().reshape(c, 1, k, k), bias, padding=(k // 2) * dilation, dilation=dilation,
                        groups=c)

    value = TF.linear(xf, u['wv'], u['bv'])
    r = dw(F.gelu(TF.linear(xf, u['wq'], u['bq'])), u['wr'], u['br'], 5, 1)
    f = torch.cat([dw(r[..., :c1], u['w1'], u['b1'], 5, 2), r[..., c1:c1 + c2],
                   dw(r[..., c1 + c2:], u['w2'], u['b2'], 7, 3)], dim=-1)
    out = TF.linear(TF.silu(TF.linear(f, u['wf'], u['bf'])) * value, u['wo'], u['bo'])
    return out.to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load('molrcm')
    if not getattr(lib, '_resselt_typed', False):
        for fn in (lib.resselt_molrcm_f32, lib.resselt_molrcm_bf16, lib.resselt_molrcm_f16):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.resselt_molrcm_weights.restype = ctypes.c_int
        if lib.resselt_molrcm_weights() != packed_size(MOLRCM_DIM):
            raise RuntimeError('csrc/molrcm.cu and ops/molrcm.py disagree on the packed weight layout')
        lib._resselt_typed = True
    return lib


def _launch(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Check the operands, launch the kernel on the current stream and count
    the launch."""
    n, h, w, dim = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f'MOLRCM kernel takes float32, bfloat16 or float16, got {x.dtype}')
    if dim != MOLRCM_DIM:
        raise ValueError(f'MOLRCM kernel takes dim {MOLRCM_DIM}, got {dim}')
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError('MOLRCM kernel needs a contiguous, 16-byte aligned x')
    if packed.device != x.device or packed.dtype != torch.float32 or not packed.is_contiguous():
        raise ValueError(f'packed MOLRCM weights must be a contiguous f32 tensor on {x.device}')
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _lib()
    fn = {torch.float32: lib.resselt_molrcm_f32, torch.bfloat16: lib.resselt_molrcm_bf16,
          torch.float16: lib.resselt_molrcm_f16}[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), packed.data_ptr(), out.data_ptr(), n, h, w, stream)
    if rc != 0:
        raise RuntimeError(f'MOLRCM kernel launch failed: CUDA error {rc} (x {tuple(x.shape)} {x.dtype})')
    fused_molrcm.launches += 1
    fused_molrcm.by_shape[(n, h, w, dim, str(x.dtype).removeprefix('torch.'))] += 1
    return out


def fused_molrcm(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The MOLRCM attention of NHWC ``x`` (after the block's norm1) with the
    weights :func:`pack_molrcm_weights` packed.  Shapes outside
    :func:`molrcm_supported` raise ValueError.  Returns a contiguous tensor
    of x's shape and dtype."""
    if x.ndim != 4:
        raise ValueError(f'fused_molrcm takes NHWC x, got shape {tuple(x.shape)}')
    n, h, w, dim = x.shape
    if not molrcm_supported(dim, h, w):
        raise ValueError(f'unsupported MOLRCM: dim={dim} h={h} w={w}')
    if packed.ndim != 1 or packed.numel() != packed_size(dim):
        raise ValueError(f'packed MOLRCM weights must hold {packed_size(dim)} floats, got {tuple(packed.shape)}')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'fused_molrcm runs on CPU or CUDA tensors, got {x.device}')
    return _MOLRCM.apply(x, packed)


class _MOLRCM(torch.autograd.Function):
    """:func:`fused_molrcm`'s forward (the kernel on the card, the plain
    version on the CPU); the backward runs autograd through the plain
    chain, recomputed."""

    @staticmethod
    def forward(ctx, x, packed):
        ctx.save_for_backward(x, packed)
        return fused_molrcm_ref(x, packed) if x.device.type == 'cpu' else _launch(x, packed)

    @staticmethod
    def backward(ctx, dout):
        x, packed = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip((x, packed), ctx.needs_input_grad[:2])]
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(fused_molrcm_ref(*leaves), wanted, dout))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


fused_molrcm.launches = 0
fused_molrcm.by_shape = Counter()
