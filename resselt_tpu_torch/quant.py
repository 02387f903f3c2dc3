"""Opt-in int8 quantized serving.

Counterpart of ``resselt_tpu/quant.py``: the same numpy code, so the two
packages quantize a state dict into the same arrays, bit for bit.

    model = resselt_tpu_torch.load_from_file('4x.safetensors').quantize_int8()

Scheme: per-output-channel symmetric int8 weights, dynamic per-tensor
activation quant, int32 accumulate, f32 rescale (``F.conv2d_int8``).
Eligibility: plain (groups == 1) convs with cin >= 32 and cout >= 32 --
head/tail and depthwise/grouped convs stay in full precision -- AND
consumption through an int8-aware op, proven by
``SRModel.quantize_int8``'s discovery run (``nn.params._INT8_DISCOVERY``):
weights reaching transposed convs, raw ``F.conv2d`` calls or a family's
own weight packing stay float.  Its speed on the H100 is in ``PERF.md``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

#: minimum cin/cout for a conv weight to be quantized
MIN_CH = 32


def eligible(key: str, arr: np.ndarray, min_ch: int = MIN_CH) -> bool:
    """Quantize only plain-conv-shaped weights wide enough to matter.

    ``arr.shape[1]`` is cin-per-group, so depthwise (1) and small-group
    (2) convs are naturally excluded; 3-channel head convs and <=31-ch
    tail projections are excluded by the same bound."""
    return (
        key.endswith('.weight')
        and arr.ndim == 4
        and arr.shape[0] >= min_ch
        and arr.shape[1] >= min_ch
    )


def quantize_weight(arr: np.ndarray):
    """Per-output-channel symmetric int8: returns (w_int8, scale_f32[O])."""
    a = np.asarray(arr, np.float64)
    s = np.max(np.abs(a), axis=(1, 2, 3)) / 127.0
    s = np.maximum(s, 1e-12)
    q = np.clip(np.round(a / s[:, None, None, None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def quantize_params(params: Mapping[str, np.ndarray], min_ch: int = MIN_CH,
                    allowed: set | None = None):
    """Return (new param dict, #convs quantized).

    Every eligible ``<name>.weight`` becomes int8 with a sibling
    ``<name>.weight_scale``; everything else is passed through.
    ``allowed``: keys proven int8-safe by consumption discovery
    (``SRModel.quantize_int8``); shape eligibility alone would also quantize
    weights consumed by transposed convs or raw ``F.conv2d`` calls, which
    have no int8 path."""
    out = {}
    n = 0
    for k, v in params.items():
        arr = np.asarray(v)
        if (allowed is None or k in allowed) and eligible(k, arr, min_ch):
            q, s = quantize_weight(arr)
            out[k] = q
            out[k + '_scale'] = s
            n += 1
        else:
            out[k] = arr
    return out, n
