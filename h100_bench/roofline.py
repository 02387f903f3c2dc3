"""The card's published peaks and each hand-written kernel's least work:
FLOPs and bytes of one launch from its shape, every input byte read once
and every output byte written once.  A launch's bound is the larger of its
FLOPs over the peak rate and its bytes over the memory bandwidth."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 / fp16 tensor-core rate, HBM3 bandwidth
PEAK_FLOPS = {'bfloat16': 989.4e12, 'float16': 989.4e12, 'float32': 66.9e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {'bfloat16': 2, 'float16': 2, 'float32': 4}


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def conv3x3(key: tuple, dtype: str) -> tuple[float, float]:
    """``fused_conv3x3_act.by_shape``'s key ``(n, h, w, cin, cout, act)``:
    a same-padded 3x3 conv, f32 bias, fused activation."""
    n, h, w, cin, cout, _act = key
    es = ELEMENT_BYTES[dtype]
    flops = 2.0 * n * h * w * 9 * cin * cout
    nbytes = es * (n * h * w * (cin + cout) + 9 * cin * cout) + 4 * cout
    return flops, nbytes


def window_attn(key: tuple, dtype: str) -> tuple[float, float]:
    """``window_mha.by_shape``'s key ``(windows, n, c, heads, masked)``:
    softmax(q k^T + bias + mask) v over every window and head.  Bytes: q,
    k, v and the output, and the (heads, n, n) f32 bias.  The shift mask is
    not counted: it is a function of the geometry alone, and the kernel
    skips the windows where it is all zero.  FLOPs: q k^T and p v."""
    windows, n, c, heads, _masked = key
    es = ELEMENT_BYTES[dtype]
    flops = 4.0 * windows * n * n * c
    nbytes = es * 4 * windows * n * c + 4 * heads * n * n
    return flops, nbytes
