"""Load-time reparameterization collapses.

Counterpart of ``resselt_tpu/nn/reparam.py``, the same functions.  The
reference recomputes these fusions at every forward in eval mode (e.g.
Conv3XC.update_params, resselt/archs/span/arch.py:124-154); here each is a
pure numpy weight-space transform executed once at load.  All functions take
and return OIHW numpy weights.
"""

from __future__ import annotations

import numpy as np


def compose_1x1_kxk(w1: np.ndarray, b1, w2: np.ndarray, b2):
    """Fuse ``conv1x1(w1) -> convkxk(w2)`` into one kxk conv."""
    # w1: (M, I, 1, 1), w2: (O, M, kh, kw)
    w = np.einsum('mi,omhw->oihw', w1[:, :, 0, 0], w2)
    b = (w2 * b1.reshape(1, -1, 1, 1)).sum(axis=(1, 2, 3)) + b2
    return w, b


def compose_kxk_1x1(w1: np.ndarray, b1, w2: np.ndarray, b2):
    """Fuse ``convkxk(w1) -> conv1x1(w2)`` into one kxk conv."""
    # w1: (M, I, kh, kw), w2: (O, M, 1, 1)
    w = np.einsum('om,mihw->oihw', w2[:, :, 0, 0], w1)
    b = (w2 * b1.reshape(1, -1, 1, 1)).sum(axis=(1, 2, 3)) + b2
    return w, b


def pad_kernel_to(w: np.ndarray, k: int) -> np.ndarray:
    """Zero-pad a smaller odd kernel to k x k, centered."""
    kh, kw = w.shape[-2:]
    ph, pw = (k - kh) // 2, (k - kw) // 2
    return np.pad(w, ((0, 0), (0, 0), (ph, k - kh - ph), (pw, k - kw - pw)))


def conv3xc_collapse(sd, prefix: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Collapse a Conv3XC bundle (1x1 -> 3x3 -> 1x1 plus 1x1 skip) into a
    single 3x3 conv (reference: resselt/archs/span/arch.py:124-150).

    Bias-free bundles (gaterv3 SPAB, arch.py:436-447) return bias None."""
    has_bias = f'{prefix}.conv.0.bias' in sd
    w1 = np.asarray(sd[f'{prefix}.conv.0.weight'], np.float64)
    w2 = np.asarray(sd[f'{prefix}.conv.1.weight'], np.float64)
    w3 = np.asarray(sd[f'{prefix}.conv.2.weight'], np.float64)
    zeros = lambda w: np.zeros(w.shape[0], np.float64)  # noqa: E731
    b1 = np.asarray(sd[f'{prefix}.conv.0.bias'], np.float64) if has_bias else zeros(w1)
    b2 = np.asarray(sd[f'{prefix}.conv.1.bias'], np.float64) if has_bias else zeros(w2)
    b3 = np.asarray(sd[f'{prefix}.conv.2.bias'], np.float64) if has_bias else zeros(w3)

    w_mid, b_mid = compose_1x1_kxk(w1, b1, w2, b2)
    w_full, b_full = compose_kxk_1x1(w_mid, b_mid, w3, b3)

    sk_w = np.asarray(sd[f'{prefix}.sk.weight'], np.float64)
    w_full = w_full + pad_kernel_to(sk_w, 3)
    if has_bias:
        b_full = b_full + np.asarray(sd[f'{prefix}.sk.bias'], np.float64)
        return w_full.astype(np.float32), b_full.astype(np.float32)
    return w_full.astype(np.float32), None


def seqconv3x3_collapse(sd, prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """Collapse SeqConv3x3 (conv1x1 -> pad-with-bias -> conv3x3) into one 3x3
    conv (reference: resselt/archs/rtmosr/arch.py:123-167 rep_params)."""
    k0 = np.asarray(sd[f'{prefix}.k0'], np.float64)
    b0 = np.asarray(sd[f'{prefix}.b0'], np.float64)
    k1 = np.asarray(sd[f'{prefix}.k1'], np.float64)
    b1 = np.asarray(sd[f'{prefix}.b1'], np.float64)
    w, b = compose_1x1_kxk(k0, b0, k1, b1)
    return w.astype(np.float32), b.astype(np.float32)


def repconv_collapse(sd, prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """Collapse RepConv = a0*SeqConv3x3 + a1*conv3x3 + a2*Conv3XC
    (reference: resselt/archs/rtmosr/arch.py:167-207 fuse)."""
    alpha = np.asarray(sd[f'{prefix}.alpha'], np.float64)
    w1, b1 = seqconv3x3_collapse(sd, f'{prefix}.conv1')
    w2 = np.asarray(sd[f'{prefix}.conv2.weight'], np.float64)
    b2 = np.asarray(sd[f'{prefix}.conv2.bias'], np.float64)
    w3, b3 = conv3xc_collapse(sd, f'{prefix}.conv3')
    w = alpha[0] * w1 + alpha[1] * w2 + alpha[2] * w3
    b = alpha[0] * b1 + alpha[1] * b2 + alpha[2] * b3
    return w.astype(np.float32), b.astype(np.float32)


def omnishift_collapse(sd, prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """Collapse OmniShift (identity + dw1x1 + dw3x3 + dw5x5, per-channel
    alphas) into one depthwise 5x5 conv
    (reference: resselt/archs/rtmosr/arch.py:253-282 reparam_5x5)."""
    a1 = np.asarray(sd[f'{prefix}.alpha1'], np.float64).reshape(-1, 1, 1, 1)
    a2 = np.asarray(sd[f'{prefix}.alpha2'], np.float64).reshape(-1, 1, 1, 1)
    a3 = np.asarray(sd[f'{prefix}.alpha3'], np.float64).reshape(-1, 1, 1, 1)
    a4 = np.asarray(sd[f'{prefix}.alpha4'], np.float64).reshape(-1, 1, 1, 1)
    w1 = np.asarray(sd[f'{prefix}.conv1x1.weight'], np.float64)
    w3 = np.asarray(sd[f'{prefix}.conv3x3.weight'], np.float64)
    w5 = np.asarray(sd[f'{prefix}.conv5x5.weight'], np.float64)
    ident = pad_kernel_to(np.ones_like(w1), 5)
    w = a1 * ident + a2 * pad_kernel_to(w1, 5) + a3 * pad_kernel_to(w3, 5) + a4 * w5
    b = (
        a2.reshape(-1) * np.asarray(sd[f'{prefix}.conv1x1.bias'], np.float64)
        + a3.reshape(-1) * np.asarray(sd[f'{prefix}.conv3x3.bias'], np.float64)
        + a4.reshape(-1) * np.asarray(sd[f'{prefix}.conv5x5.bias'], np.float64)
    )
    return w.astype(np.float32), b.astype(np.float32)


def collapse_all(sd, markers: dict[str, object]) -> dict:
    """Run every registered collapse over a state dict.

    ``markers`` maps a key suffix identifying a bundle to a
    ``(collapse_fn, out_suffix)`` pair; bundle keys are replaced by the
    collapsed conv weights under ``{prefix}.{out_suffix}``."""
    out = {}
    consumed_prefixes: list[str] = []
    for suffix, (fn, out_name) in markers.items():
        for k in list(sd.keys()):
            if k.endswith(suffix):
                prefix = k[: -len(suffix) - 1]
                w, b = fn(sd, prefix)
                out[f'{prefix}.{out_name}.weight'] = w
                if b is not None:
                    out[f'{prefix}.{out_name}.bias'] = b
                consumed_prefixes.append(prefix + '.')
    for k, v in sd.items():
        if any(k.startswith(p) for p in consumed_prefixes):
            continue
        out[k] = v
    return out


def pad_kernel_to_rect(w: np.ndarray, kh: int, kw: int) -> np.ndarray:
    h, ww = w.shape[-2:]
    ph, pw = (kh - h) // 2, (kw - ww) // 2
    return np.pad(w, ((0, 0), (0, 0), (ph, kh - h - ph), (pw, kw - ww - pw)))


def doconv_collapse(sd, prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """Collapse a DOConv2d (depthwise-over-parameterized conv) into a plain
    conv (reference: resselt/archs/smosr/arch.py:211-293 update_eval)."""
    W = np.asarray(sd[f'{prefix}.W'], np.float64)  # (out, in/g, D_mul)
    mul = float(np.asarray(sd[f'{prefix}.mul']).reshape(-1)[0])
    bias = np.asarray(sd[f'{prefix}.bias'], np.float64)
    if f'{prefix}.D' in sd:
        D = np.asarray(sd[f'{prefix}.D'], np.float64) + np.asarray(sd[f'{prefix}.d_diag'], np.float64)
        out_ch = W.shape[0]
        in_ch = D.shape[0]
        mn = D.shape[1]
        Wr = W.reshape(out_ch, in_ch, -1)  # groups=1
        dow = np.einsum('ims,ois->oim', D, Wr, optimize=True)  # (out, in, MN)
        # spatial size: D_mul == M*N here; recover (M, N) from eval_conv shape
        kh, kw = sd[f'{prefix}.eval_conv.weight'].shape[-2:]
        w_full = dow.reshape(out_ch, in_ch, kh, kw)
    else:
        w_full = W.reshape(W.shape[0], W.shape[1], 1, 1)
    return (w_full * mul).astype(np.float32), (bias * mul).astype(np.float32)


def convnxc_collapse(sd, prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """Collapse ConvNXC (DOConv 1x1 -> DOConv kxk -> DOConv 1x1 + DOConv 1x1
    skip) into a single kxk conv (reference: resselt/archs/smosr/arch.py:295-377)."""
    w1, b1 = doconv_collapse(sd, f'{prefix}.conv.0')
    w2, b2 = doconv_collapse(sd, f'{prefix}.conv.1')
    w3, b3 = doconv_collapse(sd, f'{prefix}.conv.2')
    w_mid, b_mid = compose_1x1_kxk(w1.astype(np.float64), b1.astype(np.float64), w2.astype(np.float64),
                                   b2.astype(np.float64))
    w_full, b_full = compose_kxk_1x1(w_mid, b_mid, w3.astype(np.float64), b3.astype(np.float64))
    sk_w, sk_b = doconv_collapse(sd, f'{prefix}.sk')
    kh, kw = w_full.shape[-2:]
    w_full = w_full + pad_kernel_to_rect(sk_w.astype(np.float64), kh, kw)
    b_full = b_full + sk_b
    return w_full.astype(np.float32), b_full.astype(np.float32)
