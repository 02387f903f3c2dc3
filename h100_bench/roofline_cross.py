"""The least work of one launch of ``csrc/window_cross_attn.cu`` (HAT's
overlapping cross-attention), beside ``roofline.py``'s kernels: FLOPs and
bytes from its shape, every input byte read once and every output byte
written once."""

from __future__ import annotations

from .roofline import ELEMENT_BYTES


def window_cross_attn(key: tuple, dtype: str) -> tuple[float, float]:
    """``window_cross_mha.by_shape``'s key ``(windows, n, m, c, heads)``:
    softmax(q k^T + bias) v of n queries against m keys over every window
    and head.  Bytes: q and the output (n rows), k and v (m rows), and the
    (heads, n, m) f32 bias.  FLOPs: q k^T and p v."""
    windows, n, m, c, heads = key
    es = ELEMENT_BYTES[dtype]
    flops = 4.0 * windows * n * m * c
    nbytes = es * windows * (2 * n * c + 2 * m * c) + 4 * heads * n * m
    return flops, nbytes
