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
the shape (:data:`LK_PATHS` in 16 bits), or 'f32'.  ESRGAN's dense-block
producer step (:func:`fused_conv3x3_step`: the conv with the block's glue
in the kernel's epilogue) counts as a launch of ``fused_conv3x3_act`` at
the conv's key, act ``'linear'``, and by epilogue kind in its
``by_epilogue`` Counter.  The 3x3 wrappers count their forward launches
(a step's too) by schedule in ``by_schedule``: ``(schedule, nt)``, the
kernel csrc/conv3x3.cu ran (:data:`CONV3X3_SCHEDULES` in 16 bits, as its
``resselt_conv3x3_schedule`` reports, or 'f32') and the output channels a
block holds.

Weights are either torch OIHW ``(Cout, Cin, k, k)`` or already packed into
``(k*k, Cin, Cout)`` taps in the input's dtype (:func:`pack_conv3x3_weight`,
:func:`pack_conv_lk_weight`), the kernels' layout; model code packs once
at load.

Each wrapper carries a gradient (:class:`_ConvAct`, on both devices): the
pre-activation gradient ``dz`` from the saved output (lrelu) or from the
pre-activation recomputed by one ``act='linear'`` run of the same kernel
(silu, mish); ``dx`` by the same kernel on ``dz`` with the taps turned 180
degrees and Cin / Cout swapped (``taps'[t] = taps[k*k - 1 - t].T``), or by
``torch.nn.grad.conv2d_input`` where the kernel's gate refuses that shape;
the taps' gradient by ``torch.nn.grad.conv2d_weight`` (inside the span
:data:`WEIGHT_GRAD_RANGE`); the bias's as the sum of ``dz``.
Backward launches are counted apart, in ``backward_launches`` and the
``backward_by_shape`` Counter, under the key of the conv they run (``dx``:
the transposed shape, act 'linear'; the recompute: the forward's shape, act
'linear'); a ``dx`` sent to ``conv2d_input``, under its key, in the
``backward_conv2d_input`` Counter.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch
import torch.nn.functional as TF

from .. import tracing
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
        for fn in (lib.resselt_conv3x3_step_bf16, lib.resselt_conv3x3_step_f16):
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.resselt_conv3x3_step_takes.argtypes = [ctypes.c_int] * 3
        lib.resselt_conv3x3_step_takes.restype = ctypes.c_int
        lib.resselt_conv3x3_schedule.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.resselt_conv3x3_schedule.restype = ctypes.c_int
        lib._resselt_typed = True
    return lib


# csrc/conv3x3.cu's 16-bit schedules by its enum Schedule's values: mma.sync (Cin no multiple of 16, x off 16
# bytes, or weights and halos that do not fit), and the wgmma kernel, whose two warpgroups run half a tile
# apart, one's epilogue under the other's products (pingpong)
CONV3X3_SCHEDULES = {0: 'mma', 2: 'pingpong'}


def _schedule(x: torch.Tensor, cin: int, cout: int) -> tuple:
    """``(schedule, nt)`` of a conv3x3.cu launch on ``x``: the kernel's own
    dispatch in 16 bits (:func:`_schedule_of`), ``('f32', 64)`` in f32."""
    if x.dtype == torch.float32:
        return 'f32', CONV3X3_BN
    return _schedule_of(cin, cout, x.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=None)
def _schedule_of(cin: int, cout: int, x_aligned: bool) -> tuple:
    """``resselt_conv3x3_schedule`` of a 16-bit Cin -> Cout conv, asked once
    a shape: ``(schedule, nt)``."""
    nt = ctypes.c_int(0)
    sched = _lib().resselt_conv3x3_schedule(cin, cout, int(x_aligned), ctypes.byref(nt))
    return CONV3X3_SCHEDULES[sched], nt.value


def _count(entry, key: tuple, backward: bool, schedule: tuple | None = None) -> None:
    """One launch of ``entry``'s kernel at ``key``: a forward one (by
    ``schedule`` too, where given), or one that a gradient made."""
    if backward:
        entry.backward_launches += 1
        entry.backward_by_shape[key] += 1
    else:
        entry.launches += 1
        entry.by_shape[key] += 1
        if schedule is not None:
            entry.by_schedule[schedule] += 1


def _launch(entry, x: torch.Tensor, w: torch.Tensor, b, act: str, backward: bool = False) -> torch.Tensor:
    """Check the operands, launch the kernel on the current stream and count
    the launch on ``entry``, the wrapper that asked for it (apart when a
    gradient asked for it)."""
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
        schedule = _schedule(x, cin, cout)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), taps.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
                n, h, wd, cin, cout, ACTS[act], stream)
    if rc != 0:
        raise RuntimeError(f'conv3x3 kernel launch failed: CUDA error {rc} '
                           f'(x {tuple(x.shape)} {x.dtype}, cout {cout}, act {act}, schedule {schedule})')
    _count(entry, (n, h, wd, cin, cout, act), backward, schedule)
    return y


# -- the gradient -------------------------------------------------------------

CONV3X3_BN = 64  # csrc/conv3x3.cu: output channels a block (f32 and mma.sync kernels), in gridDim.z
CONV3X3_TH = 16  # csrc/conv3x3.cu: output rows a tile


def conv3x3_kernel_takes(n: int, h: int, w: int, cin: int, cout: int) -> bool:
    """csrc/conv3x3.cu's gate (``bad_shape``, ``grid_too_large``): every
    positive shape whose grid fits, n x ceil(Cout / 64) and ceil(H / 16) at
    most 65535."""
    return (min(n, h, w, cin, cout) > 0 and n * -(-cout // CONV3X3_BN) <= 65535
            and -(-h // CONV3X3_TH) <= 65535)


def _kernel_takes(entry, k: int, n: int, h: int, w: int, cin: int, cout: int) -> bool:
    """Whether ``entry``'s kernel takes an NHWC (n, h, w, cin) -> cout conv."""
    if entry is fused_conv_lk:
        return lk_conv_supported(cin, cout, k) and min(n, h, w) > 0
    return conv3x3_kernel_takes(n, h, w, cin, cout)


def _run(entry, x: torch.Tensor, taps: torch.Tensor, b, k: int, act: str, backward: bool = False) -> torch.Tensor:
    """The conv on ``x``'s device: the kernel behind ``entry`` (the 3x3
    wrappers' or the lk one's, whatever ``k``) on the card, its plain version
    on the CPU."""
    if x.device.type == 'cpu':
        return _conv_ref(x, taps, k, b, act)
    if entry is fused_conv_lk:
        return _launch_lk(x, taps, b, k, act, backward)
    return _launch(entry, x, taps, b, act, backward)


WEIGHT_GRAD_RANGE = 'conv.backward.weight'  # the span (``tracing``) around a wrapper's weight gradient


def _act_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    """d act / dz of silu or mish at the f32 pre-activation ``z``."""
    s = torch.sigmoid(z)
    if act == 'silu':
        return s * (1 + z * (1 - s))
    t = torch.tanh(TF.softplus(z))
    return t + z * s * (1 - t * t)


class _ConvAct(torch.autograd.Function):
    """A wrapper's conv (3x3, or the lk kernel's odd k) with the gradient
    of the module docstring.  ``x``: NHWC; ``taps``: ``(k*k, Cin, Cout)``;
    ``b``: f32 or None; ``entry``: the wrapper whose counters the launches
    go to."""

    @staticmethod
    def forward(ctx, x, taps, b, k: int, act: str, entry):
        y = _run(entry, x, taps, b, k, act)
        ctx.k, ctx.act, ctx.entry = k, act, entry
        ctx.save_for_backward(x, taps, b, y if act == 'lrelu' else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, taps, b, y = ctx.saved_tensors
        k, act, entry = ctx.k, ctx.act, ctx.entry
        dz = dy.float()
        if act == 'lrelu':  # the slope of jax.nn.leaky_relu: 1 at 0
            dz = torch.where(y >= 0, dz, 0.2 * dz)
        elif act in ('silu', 'mish'):
            dz = dz * _act_grad(_run(entry, x, taps, b, k, 'linear', backward=True).float(), act)
        n, h, w, cin = x.shape
        cout = taps.shape[2]
        on_cpu = x.device.type == 'cpu'
        dx = dtaps = db = None
        if ctx.needs_input_grad[0]:
            dzx = dz.to(x.dtype).contiguous()
            if on_cpu or _kernel_takes(entry, k, n, h, w, cout, cin):
                dx = _run(entry, dzx, taps.flip(0).transpose(1, 2).contiguous(), None, k, 'linear', backward=True)
            else:
                lk_k = (k,) if entry is fused_conv_lk else ()
                entry.backward_conv2d_input[(n, h, w, cout, cin) + lk_k + ('linear',)] += 1
                w_oihw = taps.reshape(k, k, cin, cout).permute(3, 2, 0, 1)
                dx = torch.nn.grad.conv2d_input((n, cin, h, w), w_oihw, dzx.permute(0, 3, 1, 2), padding=k // 2)
                dx = dx.permute(0, 2, 3, 1).contiguous()
        if ctx.needs_input_grad[1]:
            cdt = torch.float32 if on_cpu else x.dtype
            with tracing.span(WEIGHT_GRAD_RANGE):
                dw = torch.nn.grad.conv2d_weight(x.to(cdt).permute(0, 3, 1, 2), (cout, cin, k, k),
                                                 dz.to(cdt).permute(0, 3, 1, 2), padding=k // 2)
            dtaps = dw.permute(2, 3, 1, 0).reshape(k * k, cin, cout).to(taps.dtype)
        if b is not None and ctx.needs_input_grad[2]:
            db = dz.sum((0, 1, 2))
        return dx, dtaps, db, None, None, None


def _conv_act(entry, x: torch.Tensor, w: torch.Tensor, b, k: int, act: str) -> torch.Tensor:
    """``entry``'s conv of NHWC ``x``: the weight packed (on the card in
    ``x``'s dtype, the kernel's; on the CPU in its own, the plain
    version's) and the bias taken to f32 outside the Function, so that
    autograd carries their gradients back to an OIHW weight and a bias of
    another dtype."""
    if act not in ACTS:
        raise ValueError(f'unknown activation {act!r}')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{entry.__name__} runs on CPU or CUDA tensors, got {x.device}')
    taps = _taps(w, k, x.dtype if x.device.type == 'cuda' else w.dtype)
    return _ConvAct.apply(x, taps, None if b is None else b.float(), k, act, entry)


def fused_conv3x3_act(x, w, b=None, act: str = 'linear') -> torch.Tensor:
    """Fused same-padded 3x3 conv + bias + activation.

    ``x``: (H, W, Cin) or (N, H, W, Cin), float32, bfloat16 or float16;
    ``w``: OIHW or packed taps; ``b``: (Cout,) or None; ``act``: linear, lrelu (0.2),
    silu or mish.  Output: ``x``'s dtype, ``F.conv2d(x, w, b, padding=1)``
    + activation computed with f32 accumulation; differentiable in ``x``,
    ``w`` and ``b`` (module docstring)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    y = _conv_act(fused_conv3x3_act, x, w, b, 3, act)
    return y[0] if squeeze else y


fused_conv3x3_act.launches = 0
fused_conv3x3_act.by_shape = Counter()
fused_conv3x3_act.by_epilogue = Counter()  # fused_conv3x3_step's launches by epilogue kind
fused_conv3x3_act.by_schedule = Counter()  # forward launches (steps too) by (schedule, nt)
fused_conv3x3_act.backward_launches = 0
fused_conv3x3_act.backward_by_shape = Counter()
fused_conv3x3_act.backward_conv2d_input = Counter()


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
    y = _conv_act(fused_conv3x3_pack2, x, w, b, 3, act)
    return y[0] if squeeze else y


fused_conv3x3_pack2.launches = 0
fused_conv3x3_pack2.by_shape = Counter()
fused_conv3x3_pack2.by_schedule = Counter()
fused_conv3x3_pack2.backward_launches = 0
fused_conv3x3_pack2.backward_by_shape = Counter()
fused_conv3x3_pack2.backward_conv2d_input = Counter()


# -- a dense block's producer step (ESRGAN's RDB) ------------------------------


def _step_glue(z: torch.Tensor, addend, split: int | None, residuals) -> torch.Tensor | tuple:
    """What a producer step does after its conv ``z``, as the unfused chain
    of ops does it (the plain version's glue), each op rounding to ``z``'s
    dtype: ``z + addend``, then ``(lrelu_0.2(z[..., :split]), z[...,
    split:])`` or ``z * 0.2 + r`` for each residual ``r`` in turn."""
    if addend is not None:
        z = z + addend
    if split is not None:
        return TF.leaky_relu(z[..., :split], 0.2), z[..., split:]
    for r in residuals:
        z = z * 0.2 + r
    return z


def fused_conv3x3_step_ref(x, w, b=None, *, addend=None, split=None, residuals=()):
    """Plain version of :func:`fused_conv3x3_step`: the conv's plain version
    (rounded once, after the bias), then :func:`_step_glue`."""
    return _step_glue(_conv_ref(x, w, 3, b, 'linear'), addend, split, residuals)


@functools.lru_cache(maxsize=None)
def conv3x3_step_takes(cin: int, cout: int, split: int | None) -> bool:
    """Whether a 16-bit producer step of Cin -> Cout (with ``split``, or
    None for the residuals) runs on csrc/conv3x3.cu's wgmma kernel with the
    glue in its epilogue: the kernel's own plan (``resselt_conv3x3_step_takes``:
    the shapes of its wgmma path, Cout and split multiples of 8).  Needs the
    built kernel."""
    return bool(_lib().resselt_conv3x3_step_takes(cin, cout, split or 0))


def _launch_step(x: torch.Tensor, taps: torch.Tensor, b, addend, split, residuals, kind: str):
    """One launch of the step's kernel on the current stream, counted as
    the conv's launch (``launches``, ``by_shape``) and by its epilogue's
    ``kind`` (``by_epilogue``)."""
    n, h, wd, cin = x.shape
    cout = taps.shape[2]
    y = torch.empty((n, h, wd, cout if split is None else split), dtype=x.dtype, device=x.device)
    carry = None if split is None else torch.empty((n, h, wd, cout - split), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y if carry is None else (y, carry)
    res, res2 = (*residuals, None, None)[:2]
    fn = getattr(_lib(), 'resselt_conv3x3_step_' + _ENTRY_SUFFIX[x.dtype])
    ptrs = [None if t is None else t.data_ptr() for t in (x, taps, b, addend, res, res2, y, carry)]
    with torch.cuda.device(x.device):
        schedule = _schedule(x, cin, cout)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*ptrs, n, h, wd, cin, cout, split or 0, stream)
    if rc != 0:
        raise RuntimeError(f'conv3x3 step launch failed: CUDA error {rc} '
                           f'(x {tuple(x.shape)} {x.dtype}, cout {cout}, {kind}, schedule {schedule})')
    _count(fused_conv3x3_act, (n, h, wd, cin, cout, 'linear'), False, schedule)
    fused_conv3x3_act.by_epilogue[kind] += 1
    return y if carry is None else (y, carry)


def fused_conv3x3_step(x, w, b=None, *, addend=None, split=None, residuals=()):
    """One producer step of ESRGAN's dense block (``archs/esrgan.py``): the
    conv ``z = conv3x3(x, w) + b`` of NHWC ``x``, rounded to its dtype, plus
    ``addend`` where given, then with ``split`` the pair ``(lrelu_0.2(z[...,
    :split]), z[..., split:])``, else ``z * 0.2 + r`` for each of the one or
    two ``residuals`` in turn; each op rounds where the unfused chain rounds
    (:func:`_step_glue`), so the result is the chain's bit for bit.
    ``addend`` and the residuals: ``(n, h, w, Cout)`` in ``x``'s dtype.

    On the card it is one launch of ``csrc/conv3x3.cu`` with the glue in its
    epilogue and contiguous outputs, counted in ``fused_conv3x3_act.launches``
    and ``.by_shape`` under the conv's key ``(n, h, w, cin, cout, 'linear')``
    and in ``.by_epilogue`` under its kind (``split``, ``carry_split``,
    ``carry_residual1``, ``carry_residual2``: ``carry`` where it takes an
    addend).  It takes a 16-bit step of a shape :func:`conv3x3_step_takes`
    with 16-byte aligned operands, and raises on any other: the caller
    decides, and runs :func:`fused_conv3x3_act` and the ops there.  On the
    CPU: the plain version, any float dtype and shape.  It carries no
    gradient, and raises where autograd would record one."""
    if (split is None) == (len(residuals) == 0) or len(residuals) > 2:
        raise ValueError('a producer step takes a split or one or two residuals')
    operands = (x, w, b, addend, *residuals)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        raise ValueError('fused_conv3x3_step carries no gradient: run fused_conv3x3_act and the ops under grad')
    if x.ndim != 4:
        raise ValueError(f'a producer step takes NHWC (N, H, W, C), got shape {tuple(x.shape)}')
    x = x.contiguous()
    n, h, wd, cin = x.shape
    cout = w.shape[0] if w.ndim == 4 else w.shape[-1]
    for t in (addend, *residuals):
        if t is not None and (tuple(t.shape) != (n, h, wd, cout) or t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f'addend and residuals must be ({n}, {h}, {wd}, {cout}) {x.dtype} on {x.device}, '
                             f'got {tuple(t.shape)} {t.dtype} on {t.device}')
    if split is not None and not 0 < split < cout:
        raise ValueError(f'split must lie in (0, {cout}), got {split}')
    if x.device.type == 'cpu':
        return fused_conv3x3_step_ref(x, w, b, addend=addend, split=split, residuals=residuals)
    if x.dtype not in (torch.bfloat16, torch.float16) or not conv3x3_step_takes(cin, cout, split):
        raise ValueError(f'no step kernel for a {x.dtype} conv of Cin {cin} -> Cout {cout}, split {split}: '
                         'run fused_conv3x3_act and the ops')
    addend = None if addend is None else addend.contiguous()
    residuals = tuple(r.contiguous() for r in residuals)
    taps, b32 = _kernel_weights(x, w, 3, b)
    if any(t.data_ptr() % 16 for t in (x, taps, *residuals) + (() if addend is None else (addend,))):
        raise ValueError('a producer step takes 16-byte aligned operands')
    kind = ('carry_' if addend is not None else '') + ('split' if split is not None else f'residual{len(residuals)}')
    return _launch_step(x, taps, b32, addend, split, residuals, kind)


# -- large-kernel conv (PLKSR's partial conv) ---------------------------------

# csrc/conv_lk.cu's 16-bit paths, in its enum Path's order: stacked (Cin 16,
# Cout <= 16, all weights resident), tiles (Cin 16 and 64), mma (the rest)
LK_PATHS = ('mma', 'stacked', 'tiles')


_FUSED_LK = True


def fused_lk_enabled() -> bool:
    return _FUSED_LK


def use_fused_lk(on: bool) -> None:
    """Run PLKSR's partial large-kernel convs through :func:`fused_conv_lk`
    (on, the default) or as plain ``F.conv2d`` (cuDNN on the card), for the
    process: the JAX package's kill switch
    (``resselt_tpu/ops/fused_conv.py:389``), the CLI's ``--no-fused-lk``.
    The tiled graphs are keyed on the switch."""
    global _FUSED_LK
    _FUSED_LK = bool(on)


def lk_conv_supported(cin: int, cout: int, k: int) -> bool:
    """Shapes :func:`fused_conv_lk` (and its kernel) take: cin in {8, 16, 32,
    64}, 0 < cout <= cin, k odd.  The JAX package's predicate
    (``resselt_tpu/ops/fused_conv.py:399``)."""
    return cin in (8, 16, 32, 64) and 0 < cout <= cin and k % 2 == 1


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


LK_MAX_BATCH = 65535  # csrc/conv_lk.cu: images a launch (the grid's z dimension)


def _launch_lk(x: torch.Tensor, w: torch.Tensor, b, k: int, act: str, backward: bool = False) -> torch.Tensor:
    """Check the operands, launch the lk kernel on the current stream and
    count the launch (apart when a gradient asked for it; ``by_path``
    counts the forward ones).  A batch of more than :data:`LK_MAX_BATCH`
    images goes in several launches, each counted under its own batch."""
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
    path = 'f32' if x.dtype == torch.float32 else LK_PATHS[lib.resselt_conv_lk_path(cin, cout, k, pitch, x.data_ptr())]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i0 in range(0, n, LK_MAX_BATCH):
            xi, yi = x[i0:i0 + LK_MAX_BATCH], y[i0:i0 + LK_MAX_BATCH]
            rc = fn(xi.data_ptr(), taps.data_ptr(), None if b is None else b.data_ptr(), yi.data_ptr(),
                    xi.shape[0], h, wd, cin, cout, pitch, k, ACTS[act], stream)
            if rc != 0:
                raise RuntimeError(f'lk kernel launch failed: CUDA error {rc} '
                                   f'(x {tuple(x.shape)} {x.dtype}, cout {cout}, k {k}, act {act}, path {path})')
            key = (xi.shape[0], h, wd, cin, cout, k, act)
            _count(fused_conv_lk, key, backward)
            if not backward:
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
    y = _conv_act(fused_conv_lk, x, w, b, k, act)
    return y[0] if squeeze else y


fused_conv_lk.launches = 0
fused_conv_lk.by_shape = Counter()
fused_conv_lk.by_path = Counter()
fused_conv_lk.backward_launches = 0
fused_conv_lk.backward_by_shape = Counter()
fused_conv_lk.backward_conv2d_input = Counter()
