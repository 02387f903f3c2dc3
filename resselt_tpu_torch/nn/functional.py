"""Functional NN ops with PyTorch semantics on NHWC tensors.

Counterpart of ``resselt_tpu/nn/functional.py``, holding what the port's
families use.
Feature maps are contiguous NHWC ``(N, H, W, C)``; conv weights keep the
torch OIHW layout, linear weights torch's ``(out, in)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def conv2d_int8(x, w8, w_scale, b=None, stride=1, padding=0, dilation=1):
    """int8 conv, the JAX package's ``conv2d_int8``: dynamic per-tensor
    activation quant (amax in f32, codes round-half-even(x / s_a) clipped
    to +-127), per-out-channel int8 weights, an exact int32 accumulate, then
    ``acc * (w_scale * s_a) + b`` in f32, cast back to ``x``'s dtype.

    ``w8``: int8 OIHW; ``w_scale``: f32 (O,).  groups != 1 is not supported
    (ineligible by design).  The product is one ``torch._int_mm`` over the
    im2col of the codes (on the card cuBLASLt's int8 GEMM): the channels are
    zero-padded to multiples of 8 and the rows to at least 17, as it
    requires; zeros add nothing to an integer sum, so the result is exact."""
    if w8.dtype != torch.int8:
        raise TypeError(f'conv2d_int8 takes an int8 weight, got {w8.dtype}')
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    cout, cin, kh, kw = w8.shape
    if padding == 'same':
        padding = ((kh - 1) * dh // 2, (kw - 1) * dw // 2)
    ph, pw = _pair(padding)
    n, h, w, _ = x.shape
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xf = x.float()
    # a true division on both devices: CUDA divides by a Python scalar as a
    # multiply by its reciprocal, a last-bit change that flips codes at ties
    s_a = torch.clamp(xf.abs().amax(), min=1e-12) / torch.full((), 127.0, device=x.device)
    xq = torch.clamp(torch.round(xf / s_a), -127, 127).to(torch.int8)
    cin_p, cout_p = -(-cin // 8) * 8, -(-cout // 8) * 8
    xq = TF.pad(xq, (0, cin_p - cin, pw, pw, ph, ph))
    cols = torch.stack([xq[:, i * dh : i * dh + sh * (ho - 1) + 1 : sh, j * dw : j * dw + sw * (wo - 1) + 1 : sw]
                        for i in range(kh) for j in range(kw)], dim=3)
    m = n * ho * wo
    cols = cols.reshape(m, kh * kw * cin_p)
    if m < 17:
        cols = TF.pad(cols, (0, 0, 0, 17 - m))
    wmat = TF.pad(w8.permute(0, 2, 3, 1), (0, cin_p - cin, 0, 0, 0, 0, 0, cout_p - cout))
    acc = torch._int_mm(cols, wmat.reshape(cout_p, kh * kw * cin_p).t())[:m, :cout]
    y = acc.float() * (w_scale.float() * s_a)
    if b is not None:
        y = y + b.float()
    return y.reshape(n, ho, wo, cout).to(x.dtype)


def _no_int8(w, op: str) -> None:
    if w.dtype == torch.int8:
        raise TypeError(f'int8 weight reached F.{op} without its scale: route quantized convs through '
                        f'PTree.conv, ops.conv_route.conv or F.conv2d_int8' if op == 'conv2d' else
                        f'int8 weight reached F.{op}: transposed convs have no int8 path and are '
                        f'excluded by quantize_int8 discovery')


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """2-D convolution, torch semantics. ``x``: NHWC, ``w``: OIHW.

    ``padding`` may be an int, an (ph, pw) pair, or 'same' (odd kernels).
    The product runs in ``x``'s dtype; the result is contiguous NHWC.  An
    int8 weight raises TypeError, as in the JAX package."""
    _no_int8(w, 'conv2d')
    kh, kw = w.shape[-2], w.shape[-1]
    dh, dw = _pair(dilation)
    if padding == 'same':
        padding = ((kh - 1) * dh // 2, (kw - 1) * dw // 2)
    y = TF.conv2d(
        x.permute(0, 3, 1, 2),
        w.to(x.dtype),
        None if b is None else b.to(x.dtype),
        stride=_pair(stride),
        padding=_pair(padding),
        dilation=(dh, dw),
        groups=groups,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose2d(x, w, b=None, stride=1, padding=0, output_padding=0, groups=1):
    """Torch ConvTranspose2d on NHWC ``x``; ``w``: (in, out/groups, kH, kW),
    torch's own layout.  The result is contiguous NHWC.  An int8 weight
    raises TypeError, as in the JAX package."""
    _no_int8(w, 'conv_transpose2d')
    y = TF.conv_transpose2d(
        x.permute(0, 3, 1, 2),
        w.to(x.dtype),
        None if b is None else b.to(x.dtype),
        stride=_pair(stride),
        padding=_pair(padding),
        output_padding=_pair(output_padding),
        groups=groups,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def linear(x, w, b=None):
    """Torch Linear: ``w`` is (out, in); contracts ``x``'s last dim, in
    ``x``'s dtype."""
    return TF.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last dimension (channels-last)."""
    w = None if weight is None else weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return TF.layer_norm(x, (x.shape[-1],), w, b, eps)


def relu(x):
    return TF.relu(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return TF.leaky_relu(x, negative_slope)


def gelu(x):
    """torch's default GELU, the exact erf form."""
    return TF.gelu(x)


def mish(x):
    return TF.mish(x)


def silu(x):
    return TF.silu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def prelu(x, weight):
    """PReLU on NHWC ``x``: a scalar slope, or one per channel (the last
    dimension), taken to ``x``'s dtype."""
    w = weight.to(x.dtype)
    if w.numel() != 1:
        w = w.reshape((1,) * (x.ndim - 1) + (-1,))
    return torch.where(x >= 0, x, x * w)


def hardsigmoid(x):
    """``clip(x / 6 + 0.5, 0, 1)``, the JAX package's form."""
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def softmax(x, dim: int = -1):
    return torch.softmax(x, dim=dim)


def pixel_shuffle(x, r: int):
    """torch's PixelShuffle channel order, on NHWC."""
    n, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(n, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, co)


def pixel_unshuffle(x, r: int):
    """torch's PixelUnshuffle channel order, on NHWC."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // r, w // r, c * r * r)


def pad2d(x, pads, mode: str = 'constant', value: float = 0.0):
    """Torch ``F.pad`` on NHWC spatial dims. ``pads`` = (left, right, top,
    bottom).  Negative pads crop (CUGAN's interior crops); 'reflect'
    reflects as ``jnp.pad`` does (the JAX package's), also for a pad longer
    than the input; 'constant' (with ``value``), 'replicate' and 'circular'
    are torch's ``F.pad``."""
    left, right, top, bottom = pads
    h, w = x.shape[1], x.shape[2]
    x = x[:, max(0, -top) : h - max(0, -bottom), max(0, -left) : w - max(0, -right)]
    left, right, top, bottom = (max(0, p) for p in pads)
    if max(left, right, top, bottom) == 0:
        return x
    if mode == 'reflect':
        h, w = x.shape[1], x.shape[2]
        hi = _reflect_index(h, h + bottom, top, x.device)
        wi = _reflect_index(w, w + right, left, x.device)
        return x[:, hi][:, :, wi].contiguous()
    y = TF.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom), mode=mode,
               value=value if mode == 'constant' else None)
    return y.permute(0, 2, 3, 1).contiguous()


def _reflect_index(size: int, end: int, start: int = 0, device='cpu') -> torch.Tensor:
    """numpy's ``pad(mode='reflect')`` source rows for rows ``-start`` to
    ``end - 1`` of an axis of ``size`` rows, also when a pad is longer
    than the input (the reflection repeats with period 2 * (size - 1)).
    Computed on ``device``: no host-to-device copy, which a CUDA graph
    capture would refuse."""
    i = torch.arange(-start, end, device=device)
    if size == 1:
        return torch.zeros_like(i)
    period = 2 * (size - 1)
    i = torch.remainder(i, period)
    return torch.where(i < size, i, period - i)


def pad_to_multiple(x, multiple: int, mode: str = 'reflect', value: float = 0.0):
    """Pad bottom/right so H and W are multiples of ``multiple``, by
    :func:`pad2d` in ``mode`` (reflect, the default, for any pad length)."""
    h, w = x.shape[1], x.shape[2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph == 0 and pw == 0:
        return x
    return pad2d(x, (0, pw, 0, ph), mode=mode, value=value)


def interpolate_bicubic(x, scale_factor: int):
    """torch bicubic (A = -0.75, align_corners False, no antialias) on NHWC,
    by an integer factor."""
    n, h, w, c = x.shape
    y = TF.interpolate(x.permute(0, 3, 1, 2), size=(h * scale_factor, w * scale_factor), mode='bicubic',
                       align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def _out_size(h: int, w: int, scale_factor, size) -> tuple[int, int]:
    """The output (H, W) of an interpolation: ``size``, or the input's
    times ``scale_factor`` (a number or a pair), truncated."""
    if size is not None:
        return _pair(size)
    sfh, sfw = scale_factor if isinstance(scale_factor, (tuple, list)) else (scale_factor, scale_factor)
    return int(h * float(sfh)), int(w * float(sfw))


def interpolate_nearest(x, scale_factor=None, size=None):
    """torch F.interpolate(mode='nearest'): src = floor(dst * in/out)."""
    n, h, w, c = x.shape
    oh, ow = _out_size(h, w, scale_factor, size)
    if size is None and oh % h == 0 and ow % w == 0:
        ry, rx = oh // h, ow // w
        return x[:, :, None, :, None, :].expand(n, h, ry, w, rx, c).reshape(n, oh, ow, c)
    hi = torch.floor(torch.arange(oh, device=x.device, dtype=torch.float64) * (h / oh)).long()
    wi = torch.floor(torch.arange(ow, device=x.device, dtype=torch.float64) * (w / ow)).long()
    return x[:, hi][:, :, wi].contiguous()


def interpolate_bilinear(x, scale_factor=None, size=None, align_corners: bool = False):
    """torch ``F.interpolate(mode='bilinear')`` (no antialias) on NHWC, to
    ``size`` or the input's size times ``scale_factor``; the source index
    is taken from the sizes (in / out), as the JAX package's."""
    n, h, w, c = x.shape
    y = TF.interpolate(x.permute(0, 3, 1, 2), size=_out_size(h, w, scale_factor, size), mode='bilinear',
                       align_corners=align_corners)
    return y.permute(0, 2, 3, 1).contiguous()


def max_pool2d(x, kernel, stride=None, padding=0):
    """torch ``F.max_pool2d`` on NHWC (the padding counts as -inf)."""
    y = TF.max_pool2d(x.permute(0, 3, 1, 2), _pair(kernel), _pair(stride if stride is not None else kernel),
                      _pair(padding))
    return y.permute(0, 2, 3, 1).contiguous()


def rms_norm(x, weight=None, offset: float = 0.0, eps: float = 1e-6):
    """RMSNorm over the last dimension, eps inside the rsqrt; ``weight``
    (+ ``offset``) scales the result."""
    y = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * (weight.to(x.dtype) + offset)
    return y


def rms_norm_ref(x, scale, offset, eps: float = 1e-6):
    """RMSNorm with eps added outside the sqrt (the MoSRv2 lineage's
    channel RMSNorm): ``scale * x / (rms + eps) + offset``."""
    rms = (x * x).mean(dim=-1, keepdim=True).sqrt()
    return scale.reshape(-1).to(x.dtype) * (x / (rms + eps)) + offset.reshape(-1).to(x.dtype)


def batch_norm_2d(x, weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Inference-mode BatchNorm2d over NHWC channels, with the running
    statistics and affine params taken to ``x``'s dtype first; one
    multiply-add: ``x * s + (bias - mean * s)``, ``s = weight / sqrt(var +
    eps)``."""
    s = torch.rsqrt(running_var.to(x.dtype) + eps) * weight.to(x.dtype)
    return torch.addcmul(bias.to(x.dtype) - running_mean.to(x.dtype) * s, x, s)


def group_norm(x, num_groups: int, weight=None, bias=None, eps: float = 1e-5):
    """GroupNorm over NHWC: statistics per sample and group, over the whole
    image and the group's channels."""
    w = None if weight is None else weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return TF.group_norm(x.permute(0, 3, 1, 2), num_groups, w, b, eps).permute(0, 2, 3, 1).contiguous()


def grid_sample_bilinear(x, grid, align_corners: bool = False, padding_mode: str = 'zeros'):
    """torch ``grid_sample(mode='bilinear')`` on NHWC ``x``; ``grid``:
    (N, Ho, Wo, 2), xy in [-1, 1] (grid[..., 0] = x/width, [..., 1] =
    y/height).  ``padding_mode`` 'zeros' or 'border', as the JAX package."""
    if padding_mode not in ('zeros', 'border'):
        raise NotImplementedError(f'grid_sample padding_mode {padding_mode!r} not supported')
    y = TF.grid_sample(x.permute(0, 3, 1, 2), grid.to(x.dtype), mode='bilinear',
                       padding_mode=padding_mode, align_corners=align_corners)
    return y.permute(0, 2, 3, 1).contiguous()
