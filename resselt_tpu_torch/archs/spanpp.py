"""SpanPP: SPAN with the IGConv implicit-Fourier arbitrary-scale upsampler.

Counterpart of ``resselt_tpu/archs/spanpp.py``: the same config inference,
metadata and forward.  RepConv bundles collapse at load
(``nn.reparam.collapse_all`` with ``repconv_collapse``); the IGConv
per-scale kernels are synthesized once at load as a numpy weight transform
(the reference does it in ``train()``, spanpp/arch.py:277-291).
``metadata.upscale`` is the scale *list* (spanpp/__init__.py:123); the
forward runs at ``eval_scale`` (2, the reference default), and
``with_config(eval_scale=s)`` or the CLI's ``--scale`` picks another.  The
SPAN body is the port's ``span.body``, so each 3x3 conv runs through
``ops.fused_conv3x3_act`` (``csrc/conv3x3.cu``) with c1's and c2's SiLU
fused; the IGConv eval conv does too when its kernel is 3x3 (21 launches per
forward).  The weights, every scale's eval conv among them, are packed once
per compute dtype (``prepare``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from ..core.state_dict import get_seq_len
from ..nn import functional as F
from ..nn.params import PTree
from ..nn.reparam import collapse_all, repconv_collapse
from ..ops.conv_route import conv, prepare_convs
from .span import body


@dataclass(frozen=True)
class SpanPPConfig:
    num_in_ch: int
    feature_channels: int
    scale_list: tuple[int, ...]
    eval_scale: int  # scale used by apply (reference default base_scale=2)
    ig_kernel: int
    implicit_dim: int
    latent_layers: int


def _make_coord(n: int) -> np.ndarray:
    """LIIF-style cell-centered coords in [-1, 1] (spanpp/arch.py:219-232)."""
    r = 2.0 / (2 * n)
    seq = -1 + r + 2 * r * np.arange(n, dtype=np.float32)
    yy, xx = np.meshgrid(seq, seq, indexing='ij')
    # stack then flip(-1): component order becomes (x, y)
    return np.stack([xx, yy], axis=-1)  # (n, n, 2) -> [...,0]=x


def synthesize_igconv_kernel(sd, scale: int, dim: int, k: int, implicit_dim: int,
                             latent_layers: int, max_s: int) -> np.ndarray:
    """_implicit_representation_latent as a numpy transform
    (spanpp/arch.py:293-321). Returns an OIHW conv weight (3*s*s, dim, k, k)."""
    freq = np.asarray(sd['upsampler.freq'], np.float64)[:, :, 0, 0]  # (dim*k*k, D)
    amplitude = np.asarray(sd['upsampler.amplitude'], np.float64)[:, :, 0, 0]
    phase_w = np.asarray(sd['upsampler.phase.weight'], np.float64)[:, 0, 0, 0]  # (D/2,)
    phase_b = np.asarray(sd['upsampler.phase.bias'], np.float64)

    half = implicit_dim // 2
    scale_phase = min(scale, max_s)
    r = 2.0 / scale_phase
    coords = _make_coord(scale).astype(np.float64)  # (s, s, 2), [...,0]=x
    cx = coords[..., 0]  # torch coords[:, :1] after permute = first channel = x
    cy = coords[..., 1]

    f1 = freq[:, :half]  # (N, D/2)
    f2 = freq[:, half:]
    # (N, D/2, s, s)
    fr = f1[:, :, None, None] * cx[None, None] + f2[:, :, None, None] * cy[None, None]
    phase = phase_w[None, :, None, None] * r + phase_b[None, :, None, None]
    fr = fr + phase
    basis = np.concatenate([np.cos(np.pi * fr), np.sin(np.pi * fr)], axis=1)  # (N, D, s, s)
    h = basis * amplitude[:, :, None, None]

    # query_kernel: 1x1 conv stack = per-position matmul
    for i in range(latent_layers):
        w = np.asarray(sd[f'upsampler.query_kernel.{2 * i}.weight'], np.float64)[:, :, 0, 0]
        b = np.asarray(sd[f'upsampler.query_kernel.{2 * i}.bias'], np.float64)
        h = np.einsum('od,ndhw->nohw', w, h, optimize=True) + b[None, :, None, None]
        h = np.maximum(h, 0)
    w = np.asarray(sd[f'upsampler.query_kernel.{2 * latent_layers}.weight'], np.float64)[:, :, 0, 0]
    b = np.asarray(sd[f'upsampler.query_kernel.{2 * latent_layers}.bias'], np.float64)
    h = np.einsum('od,ndhw->nohw', w, h, optimize=True) + b[None, :, None, None]  # (N, 3, s, s)

    # '(Cin Kh Kw) RGB rh rw -> (RGB rh rw) Cin Kh Kw'
    h = h.reshape(dim, k, k, 3, scale, scale).transpose(3, 4, 5, 0, 1, 2)
    return h.reshape(3 * scale * scale, dim, k, k).astype(np.float32)


def prepare(cfg: SpanPPConfig, params, dtype):
    return prepare_convs(params, dtype)


def apply(cfg: SpanPPConfig, w: dict, x):
    """Forward on NHWC ``x`` with ``w = prepare(cfg, params, x.dtype)``, at
    ``cfg.eval_scale``."""
    p = PTree(w)
    out = body(p, conv(p['conv0.conv_3x3_rep'], x), rep='conv_3x3_rep')
    s = cfg.eval_scale
    return F.pixel_shuffle(conv(p[f'upsampler.eval_convs.{s}'], out), s)


_MARKERS = {'alpha': (repconv_collapse, 'conv_3x3_rep')}


def _load(sd, device='cuda') -> SRModel:
    """Config inference, as ``resselt_tpu/archs/spanpp.py::_load``."""
    dim, in_ch = sd['conv0.conv_3x3_rep.weight'].shape[:2]
    if 'MetaIGConv' in sd:
        scales = tuple(int(v) for v in np.asarray(sd['MetaIGConv']).reshape(-1))
    else:
        scales = (1, 2, 3, 4)
    ig_kernel_total, implicit_dim = sd['upsampler.freq'].shape[:2]
    ig_kernel = int((ig_kernel_total / dim) ** 0.5)
    latent_layers = get_seq_len(sd, 'upsampler.query_kernel') // 2

    cfg = SpanPPConfig(
        num_in_ch=in_ch, feature_channels=dim, scale_list=scales,
        eval_scale=2, ig_kernel=ig_kernel, implicit_dim=implicit_dim,
        latent_layers=latent_layers,
    )
    params = collapse_all(sd, _MARKERS)
    max_s = max(scales)
    for s in sorted(set(scales)):
        params[f'upsampler.eval_convs.{s}.weight'] = synthesize_igconv_kernel(
            sd, s, dim, ig_kernel, implicit_dim, latent_layers, max_s
        )
    drop_prefixes = ('upsampler.freq', 'upsampler.amplitude', 'upsampler.phase', 'upsampler.query_kernel', 'MetaIGConv')
    params = {k: v for k, v in params.items() if not k.startswith(drop_prefixes)}
    meta = ModelMetadata(in_channels=in_ch, out_channels=in_ch, upscale=list(scales), name='SpanPP')
    return SRModel('SpanPP', cfg, params_from_numpy(params, device), meta, apply, prepare)


ARCH = Architecture(
    id='SpanPP',
    detect_condition=KeyCondition.has_all(
        'conv0.alpha',
        'conv0.conv1.k0',
        'conv0.conv1.b1',
        'conv0.conv2.weight',
        'conv0.conv3.sk.weight',
        'conv0.conv3.eval_conv.weight',
        'conv0.conv_3x3_rep.weight',
        'block_1.c1_r.alpha',
        'block_1.c1_r.conv_3x3_rep.weight',
        'block_6.c3_r.conv_3x3_rep.weight',
        'conv_cat.weight',
        'conv_2.alpha',
        'conv_2.conv_3x3_rep.weight',
        'upsampler.freq',
        'upsampler.amplitude',
        'upsampler.phase.weight',
        'upsampler.query_kernel.0.weight',
    ),
    load_fn=_load,
)
